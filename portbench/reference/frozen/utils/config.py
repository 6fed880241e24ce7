# Frozen copy of ngp_tpu_torch/utils/config.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Model-config loading: commented JSON / msgpack, reference-compatible keys.

Counterpart: ngp_tpu/utils/config.py:1-324, copied (stdlib only; an unused
import dropped) so that the port imports nothing of ngp_tpu.

The reference parses one JSON document with five sections — `samlper` (sic,
the typo'd key is load-bearing: testbed.cu:67 reads exactly that), `network`,
`render`, `loss`, `optimizer`, `envmap` — with per-consumer defaults
(occupancy_sampler.cu:605-630, ray_marcher.cu:298-303, ngp_network.h:602-642,
base.json). We parse the same document into typed config dataclasses and
reproduce every default and derived quantity.
"""

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

SQRT3 = math.sqrt(3.0)

# de-facto config constants (reference internal/utils/common.h:57-61)
MARCH_ITER = 10000
BATCH_SIZE_MULTIPLE = 256
LOSS_SCALE = 128.0


def load_commented_json(path):
    """Parse JSON allowing // and /* */ comments (reference uses nlohmann
    comment-tolerant parsing, testbed.cu:56; python side uses commentjson)."""
    text = Path(path).read_text()
    return parse_commented_json(text)


def parse_commented_json(text: str):
    # strip // line comments and /* */ block comments outside of strings
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 1
            elif c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return json.loads("".join(out))


@dataclass(frozen=True)
class SamplerConfig:
    """`samlper` section; defaults per occupancy_sampler.cu:605-630."""

    aabb_scale: int = 1
    grid_size: int = 128
    ema_decay: float = 0.95
    maximum_marching_steps: int = 1024
    cone_angle_constant: float = 0.0
    near_distance: float = 0.2
    far_distance: float = 100.0
    snap_to_pixel_centers_in_training: bool = True
    snap_to_pixel_centers_in_rendering: bool = True
    min_optical_thickness: float = 0.01

    @property
    def n_cascades(self) -> int:
        # n_cascades = 2, then grow while 2^(n-1) < aabb_scale
        # (occupancy_sampler.cu:611-612 — note: minimum is 2, even for scale 1)
        n = 2
        while (1 << (n - 1)) < self.aabb_scale:
            n += 1
        return n

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / self.maximum_marching_steps  # occupancy_sampler.cu:624

    @property
    def max_cone_stepsize(self) -> float:
        return SQRT3 * (1 << (self.n_cascades - 1)) / self.grid_size  # cu:625

    @property
    def n_grid_elements(self) -> int:
        return self.grid_size**3

    @property
    def n_total_elements(self) -> int:
        return self.n_grid_elements * self.n_cascades


@dataclass(frozen=True)
class HashEncodingConfig:
    """`network.encoding`; derivation per ngp_network.h:602-642."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    desired_resolution: float = 2048.0
    per_level_scale: float = 0.0  # 0 -> auto
    # "oadd": fully-additive linear hash, oct-packed table fetches (4x fewer
    # gather/scatter rows than xadd on TPU; ops/hash_encoding.py). "xadd":
    # x-additive hash, pair-packed (2x). "tcnn": tiny-cuda-nn's exact XOR
    # hash, for reference-checkpoint interchange.
    hash_variant: str = "oadd"
    # hash backward deposits the full gradient into ONE corner drawn
    # proportionally to its trilinear weight instead of weighted deposits
    # into all 8 — an unbiased estimator of the dense deposit (tests/
    # test_stochastic_bwd.py) that cuts the backward scatter width 8x.
    # A/B-validated on the 640-step same-seed harness: +0.20 dB, 0.82x step
    # time (tools/ab_quality.py, ROADMAP round-3 table). Default ON as the
    # oadd training path; set False for the reference's exact all-corner
    # deposit semantics (tcnn HashGrid backward, ngp_network.h:162) — the
    # "tcnn"/"xadd" variants always use their exact backwards.
    stochastic_corner_backward: bool = True
    # With the one-corner draw on, additionally deposit each sample's
    # gradient into only every k-th LEVEL (levels l with l % k == i % k for
    # sample index i), scaled by k. Samples are freshly drawn and jittered
    # every step, so the level subset a physical point feeds is effectively
    # re-randomized per step: E[deposit] = the dense deposit. Cuts the
    # backward scatter rows (the dominant bwd cost, ~14 ns/row floor)
    # k-fold via strided slices. 1 = off (every level). Default 2 from the
    # 3-arm 640-step A/B (tools/ab_quality.py, ROADMAP round-3): rate 2 is
    # 0.95x the step time at +1.06 dB vs every-level; rate 4 loses 0.6 dB.
    stochastic_level_rate: int = 2

    @property
    def scale(self) -> float:
        if self.per_level_scale > 0:
            return self.per_level_scale
        if self.n_levels <= 1:
            return 1.0
        return math.exp(math.log(self.desired_resolution / self.base_resolution) / (self.n_levels - 1))

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def hashmap_size(self) -> int:
        return 1 << self.log2_hashmap_size


@dataclass(frozen=True)
class MLPConfig:
    """`network.network` / `network.rgb_network` FullyFusedMLP sections."""

    activation: str = "ReLU"
    output_activation: str = "None"
    n_neurons: int = 64
    n_hidden_layers: int = 1


@dataclass(frozen=True)
class NetworkConfig:
    encoding: HashEncodingConfig = field(default_factory=HashEncodingConfig)
    density_mlp: MLPConfig = field(default_factory=MLPConfig)
    sh_degree: int = 4  # `dir_encoding.degree`
    rgb_mlp: MLPConfig = field(default_factory=lambda: MLPConfig(n_hidden_layers=2))
    density_n_output_dims: int = 16  # ngp_network.h:170


@dataclass(frozen=True)
class RenderConfig:
    """`render` section; defaults per ray_marcher.cu:298-303."""

    train_with_random_bg_color: bool = True
    train_in_linear_color: bool = False
    transmittance_threshold: float = 1e-4


@dataclass(frozen=True)
class AdamConfig:
    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    # tcnn adam.h knob (same name/default): false = a param whose gradient is
    # exactly zero this step is skipped entirely (no moment decay, no update).
    # Applied to the hash-table leaves (MLP grads are dense, never zero).
    optimize_params_when_gradient_is_zero: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    """Flattened Ema(ExponentialDecay(Adam)) stack (base.json:50-67)."""

    ema_decay: float = 0.95
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33
    adam: AdamConfig = field(default_factory=AdamConfig)


@dataclass(frozen=True)
class EnvmapConfig:
    train: bool = False
    height: int = 256
    width: int = 256
    loss: str = "RelativeL2"
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            ema_decay=0.99,
            decay_start=10000,
            decay_interval=5000,
            decay_base=0.33,
            adam=AdamConfig(epsilon=1e-10, l2_reg=1e-10),
        )
    )


@dataclass(frozen=True)
class NGPConfig:
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: str = "SmoothL1"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    envmap: EnvmapConfig = field(default_factory=EnvmapConfig)

    raw: dict = field(default_factory=dict, compare=False)

    @staticmethod
    def from_json(doc: dict) -> "NGPConfig":
        return _config_from_json(doc)

    @staticmethod
    def from_file(path) -> "NGPConfig":
        return _config_from_json(load_commented_json(path))


def _take(d: dict, cls, mapping=None, **overrides):
    """Build dataclass `cls` from dict `d`, honoring only known fields."""
    mapping = mapping or {}
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        k = mapping.get(k, k)
        if k in names:
            kwargs[k] = v
    kwargs.update(overrides)
    return cls(**kwargs)


def _optimizer_from_json(doc: dict) -> OptimizerConfig:
    """Parse the nested Ema(ExponentialDecay(Adam)) stack from base.json:50-67.

    Any layer may be omitted; unknown extra Adam knobs (beta3 etc., used only
    by the envmap's Shampoo-flavored config) are ignored.
    """
    if not doc:
        return OptimizerConfig()
    ema_decay = 0.0
    decay_start, decay_interval, decay_base = 0, 1, 1.0
    adam = AdamConfig()
    node = doc
    while node:
        otype = str(node.get("otype", "Adam")).lower()
        if otype == "ema":
            ema_decay = float(node.get("decay", 0.95))
        elif otype == "exponentialdecay":
            decay_start = int(node.get("decay_start", 0))
            decay_interval = int(node.get("decay_interval", 1))
            decay_base = float(node.get("decay_base", 1.0))
        elif otype == "adam":
            adam = _take(node, AdamConfig)
        node = node.get("nested")
    return OptimizerConfig(
        ema_decay=ema_decay,
        decay_start=decay_start,
        decay_interval=decay_interval,
        decay_base=decay_base,
        adam=adam,
    )


def _config_from_json(doc: dict) -> NGPConfig:
    sampler = _take(doc.get("samlper", doc.get("sampler", {})), SamplerConfig)
    net = doc.get("network", {})
    encoding = _take(net.get("encoding", {}), HashEncodingConfig)
    density_mlp = _take(net.get("network", {}), MLPConfig)
    rgb_mlp = _take(net.get("rgb_network", {}), MLPConfig, n_hidden_layers=net.get("rgb_network", {}).get("n_hidden_layers", 2))
    network = NetworkConfig(
        encoding=encoding,
        density_mlp=density_mlp,
        sh_degree=int(net.get("dir_encoding", {}).get("degree", 4)),
        rgb_mlp=rgb_mlp,
        density_n_output_dims=int(net.get("network", {}).get("n_output_dims", 16)),
    )
    render = _take(doc.get("render", {}), RenderConfig)
    envmap_doc = doc.get("envmap", {})
    envmap = EnvmapConfig(
        train=bool(envmap_doc.get("train", False)),
        height=int(envmap_doc.get("height", 256)),
        width=int(envmap_doc.get("width", 256)),
        loss=str(envmap_doc.get("loss", "RelativeL2")),
        optimizer=_optimizer_from_json(envmap_doc.get("optimizer", {})) if envmap_doc.get("optimizer") else EnvmapConfig().optimizer,
    )
    return NGPConfig(
        sampler=sampler,
        network=network,
        render=render,
        loss=str(doc.get("loss", "SmoothL1")),
        optimizer=_optimizer_from_json(doc.get("optimizer", {})),
        envmap=envmap,
        raw=doc,
    )
