# Frozen copy of ngp_tpu_torch/models/ngp.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""The NGP NeRF model: hash encode -> density MLP -> [+SH] -> RGB MLP.

Counterpart: ngp_tpu/models/ngp.py:37-199 (NGPModel.create/init,
prepare_inference, density_raw, rgbsigma_raw and the transfer functions).
Differs: NGPModel is an nn.Module that owns its parameters (hash table in
the (L, T_pad, F) layout, MLP matrices as (in, out) fp32 lists) instead of a
static definition over a separate pytree; the heads are the mlp_apply chain
(the frozen copy has no fused kernel), whose operand rounding ops/mlp.py's
PRECISION sets. Training turns on requires_grad (`trainable`); rgbsigma_raw
is then differentiable in every parameter (the hash table through
hash_encode_const_pos's backward for the spec's hash variant), while
density_raw stays a no-grad mlp_apply, as ngp_tpu's grid update uses it.
`input_gradient` (the Normals render mode) has its own path: the density
head on hash_encode_pos_grad, differentiated by autograd in pos alone.
"""

import torch
from torch import nn

from portbench.reference.frozen.ops.hash_encoding import (
    HashGridSpec,
    hash_encode,
    hash_encode_const_pos,
    hash_encode_pos_grad,
    hash_table_init,
)
from portbench.reference.frozen.ops.mlp import mlp_apply, mlp_init
from portbench.reference.frozen.ops.sh_encoding import sh_encode
from portbench.reference.frozen.utils.config import NetworkConfig
from portbench.reference.frozen.utils.device import resolve_device


class NGPModel(nn.Module):
    """Hash grid + two bias-free MLP heads; parameters live on `device`
    (the card unless the caller passes another one)."""

    def __init__(self, config: NetworkConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.grid_spec = HashGridSpec.create(config.encoding)
        spec = self.grid_spec
        kw = dict(dtype=torch.float32, device=device)
        self.hash_table = nn.Parameter(
            torch.zeros((spec.n_levels, spec.padded_size, spec.n_features), **kw), requires_grad=False
        )
        d_dims = self._dims(spec.n_output_dims, config.density_mlp, config.density_n_output_dims)
        r_dims = self._dims(config.density_n_output_dims + config.sh_degree**2, config.rgb_mlp, 3)
        self.density_mlp = nn.ParameterList(
            [nn.Parameter(torch.zeros(s, **kw), requires_grad=False) for s in d_dims]
        )
        self.rgb_mlp = nn.ParameterList([nn.Parameter(torch.zeros(s, **kw), requires_grad=False) for s in r_dims])

    @staticmethod
    def _dims(n_in, mcfg, n_out):
        dims = [n_in] + [mcfg.n_neurons] * mcfg.n_hidden_layers + [n_out]
        return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]

    @staticmethod
    def create(config: NetworkConfig, device=None) -> "NGPModel":
        return NGPModel(config, device=device)

    # ---------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Uniform(+-1e-4) hash table and Xavier-uniform MLPs from `generator`
        (torch's stream, not JAX's threefry: tests inject JAX's draws through
        load_params instead)."""
        cfg, spec = self.config, self.grid_spec
        sh_dims = cfg.sh_degree**2
        dout = cfg.density_n_output_dims
        params = {
            "hash_table": hash_table_init(generator, spec),
            "density_mlp": mlp_init(
                generator, spec.n_output_dims, cfg.density_mlp.n_neurons, dout, cfg.density_mlp.n_hidden_layers
            ),
            "rgb_mlp": mlp_init(generator, dout + sh_dims, cfg.rgb_mlp.n_neurons, 3, cfg.rgb_mlp.n_hidden_layers),
        }
        self.load_params(params)
        return self

    @torch.no_grad()
    def load_params(self, params: dict):
        """Copy a {hash_table (L, T_pad, F), density_mlp, rgb_mlp} dict in."""
        self.hash_table.copy_(params["hash_table"])
        for dst, src in zip(self.density_mlp, params["density_mlp"], strict=True):
            dst.copy_(src)
        for dst, src in zip(self.rgb_mlp, params["rgb_mlp"], strict=True):
            dst.copy_(src)
        return self

    def params(self) -> dict:
        """The parameters as the dict load_params takes (live tensors)."""
        return {"hash_table": self.hash_table, "density_mlp": list(self.density_mlp), "rgb_mlp": list(self.rgb_mlp)}

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def trainable(self, on: bool = True):
        """Turn requires_grad on (training) or off for every parameter."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self

    def param_list(self) -> list:
        """[hash_table, *density_mlp, *rgb_mlp]: the optimizer's leaf order."""
        return [self.hash_table, *self.density_mlp, *self.rgb_mlp]

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def density_raw(self, pos: torch.Tensor) -> torch.Tensor:
        """pos: (N, 3) warped in [0,1] -> raw density-head output (N, 16)."""
        enc = hash_encode(self.hash_table, pos, self.grid_spec)
        cfg = self.config.density_mlp
        return mlp_apply(list(self.density_mlp), enc, cfg.activation, cfg.output_activation)

    def rgbsigma_raw(self, pos: torch.Tensor, warped_dir: torch.Tensor):
        """(N,3), (N,3) -> raw (rgb (N,3), sigma (N,)) pre-activation;
        differentiable in the parameters when they require grad."""
        train = torch.is_grad_enabled() and self.hash_table.requires_grad
        if train:
            enc = hash_encode_const_pos(self.hash_table, pos, self.grid_spec)
        else:
            enc = hash_encode(self.hash_table, pos, self.grid_spec)
        sh = sh_encode(warped_dir, self.config.sh_degree)
        dcfg, rcfg = self.config.density_mlp, self.config.rgb_mlp
        density_out = mlp_apply(list(self.density_mlp), enc, dcfg.activation, dcfg.output_activation)
        rgb_in = torch.cat([density_out, sh], dim=-1)
        rgb_raw = mlp_apply(list(self.rgb_mlp), rgb_in, rcfg.activation, rcfg.output_activation)
        return rgb_raw, density_out[:, 0]

    def input_gradient(self, pos: torch.Tensor, density_activation: str = "Exponential") -> torch.Tensor:
        """d(density)/d(warped pos), (N, 3): the gradient in pos of
        sum(density_activation(density_raw(pos)[:, 0])) (ngp_tpu's
        input_gradient, models/ngp.py:156-166; the Normals mode). Runs under
        its own enable_grad on a detached pos, so it works inside no_grad
        and leaves no gradient on the parameters."""
        cfg = self.config.density_mlp
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            enc = hash_encode_pos_grad(self.hash_table, p, self.grid_spec)
            raw = mlp_apply(list(self.density_mlp), enc, cfg.activation, cfg.output_activation)[:, 0]
            (grad,) = torch.autograd.grad(apply_density_activation(raw, density_activation).sum(), p)
        return grad


# ------------------------------------------------------------ transfer fns
# Reference: common_device.h:292-342. Defaults: density Exponential with
# clamped inputs; rgb Logistic.


def apply_rgb_activation(raw: torch.Tensor, activation: str = "Logistic") -> torch.Tensor:
    a = activation.lower()
    if a == "none":
        return raw
    if a == "relu":
        return torch.relu(raw)
    if a == "logistic":
        return torch.sigmoid(raw)
    if a == "exponential":
        return torch.exp(torch.clamp(raw, -10.0, 10.0))
    raise ValueError(f"Unknown rgb activation {activation}")


def apply_density_activation(raw: torch.Tensor, activation: str = "Exponential") -> torch.Tensor:
    a = activation.lower()
    if a == "none":
        return raw
    if a == "relu":
        return torch.relu(raw)
    if a == "logistic":
        return torch.sigmoid(raw)
    if a == "exponential":
        return torch.exp(torch.clamp(raw, -15.0, 15.0))
    raise ValueError(f"Unknown density activation {activation}")
