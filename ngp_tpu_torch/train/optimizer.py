"""Optimizer: lazy Adam + stepped exponential LR decay + parameter EMA.

Counterpart: ngp_tpu/train/optimizer.py:31-39 (lr_factor), :42-95
(scale_by_adam_lazy), :98-135 (create_optimizer: L2 on the MLP matrices
only, the hash table lazy), :138-150 (create_optimizer_flat, the envmap's
dense single-leaf chain) and :153-155 (ema_update), and
tools/mb22_optfuse.py:56-89, the Pallas kernel that fuses one step of a leaf.
Same counters as the optax chain: the bias corrections use the Adam count
starting at 1, the learning rate the schedule's count starting at 0; both
are kept, read out (`state`) and installed (`load_state`). Differs:
the state is a plain object updated in place, and every leaf goes through
one fused kernel (csrc/adam_ema.cu) on the card, with `lazy` on for the hash
table and `l2` for the MLP matrices; `adam_ema_plain` is its plain version.
The step's learning rate and bias corrections reach the kernel as a float32
row on the card (`hyper`), not as launch arguments, so a training step
captured in a CUDA graph takes each replay's values.
"""

import ctypes

import numpy as np
import torch

from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.utils import profiling
from ngp_tpu_torch.utils.config import OptimizerConfig
from ngp_tpu_torch.utils.fma import sqrt_rn


def lr_factor(step: int, cfg: OptimizerConfig) -> np.float32:
    """Stepped decay factor base^(1 + (step - start) // interval) after start."""
    n = 0 if step < cfg.decay_start else (step - cfg.decay_start) // cfg.decay_interval + 1
    return np.power(np.float32(cfg.decay_base), np.float32(n))


HYPER_COLUMNS = ("lr", "bc1", "bc2")  # one float32 row of the step table per step


def _constants(b1, b2, eps, decay):
    return dict(
        b1=np.float32(b1), one_minus_b1=np.float32(1.0 - b1), b2=np.float32(b2), one_minus_b2=np.float32(1.0 - b2),
        eps=np.float32(eps), decay=np.float32(decay), one_minus_decay=np.float32(1.0 - decay),
    )


def _check_hyper(hyper, p):
    if hyper.dtype != torch.float32 or tuple(hyper.shape) != (3,) or not hyper.is_contiguous() or hyper.device != p.device:
        raise ValueError("hyper must be a contiguous float32 (lr, bc1, bc2) row on p's device")


def adam_ema_plain(g, m, v, p, e, hyper, *, b1, b2, eps, decay, l2=0.0, lazy=False):
    """The kernel's function in plain torch, in place on m, v, p, e (fp32,
    same shape): L2, lazy Adam, the lr step and the EMA, in the kernel's
    order of operations (float32 constants, correctly rounded sqrt). `hyper`
    is the step's (lr, bc1, bc2) row, float32 on p's device, as the kernel
    reads it. The constants live on p's device: torch divides a CUDA tensor
    by a CPU scalar through its reciprocal, which is not IEEE division."""
    _check_hyper(hyper, p)
    h = {k: torch.tensor(float(x), dtype=torch.float32, device=p.device) for k, x in _constants(b1, b2, eps, decay).items()}
    lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
    if l2 != 0.0:
        g = g + torch.tensor(l2, dtype=torch.float32, device=p.device) * p
    nm = h["b1"] * m + h["one_minus_b1"] * g
    nv = h["b2"] * v + h["one_minus_b2"] * g * g
    upd = (nm / bc1) / (sqrt_rn(nv / bc2) + h["eps"])
    if lazy:
        visited = g != 0
        nm, nv = torch.where(visited, nm, m), torch.where(visited, nv, v)
        upd = torch.where(visited, upd, 0.0)
    m.copy_(nm)
    v.copy_(nv)
    p.copy_(p - lr * upd)
    e.copy_(h["decay"] * e + h["one_minus_decay"] * p)


def _library():
    lib = kernels.library("adam_ema")
    p, f = ctypes.c_void_p, ctypes.c_float
    lib.adam_ema.argtypes = [p, p, p, p, p, ctypes.c_longlong, p] + [f] * 8 + [ctypes.c_int, p]
    lib.adam_ema.restype = ctypes.c_int
    return lib


def adam_ema_cuda(g, m, v, p, e, hyper, *, b1, b2, eps, decay, l2=0.0, lazy=False):
    """Launch the fused kernel on the current stream; updates m, v, p, e in
    place. The kernel reads the step's (lr, bc1, bc2) through the `hyper`
    pointer, so a launch captured in a CUDA graph takes each replay's row."""
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p), ("e", e)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must be contiguous float32 of p's shape on p's device")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves four elements at a time)")
    _check_hyper(hyper, p)
    c = _constants(b1, b2, eps, decay)
    err = _library().adam_ema(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(), e.data_ptr(), p.numel(), hyper.data_ptr(),
        *(float(c[k]) for k in ("b1", "one_minus_b1", "b2", "one_minus_b2", "eps", "decay", "one_minus_decay")),
        float(l2), int(bool(lazy)), torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_ema launch failed: CUDA error {err}")
    profiling.count("launches.adam_ema")


def adam_ema(g, m, v, p, e, hyper, **kw):
    """One fused step: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if p.device.type == "cuda":
        return adam_ema_cuda(g, m, v, p, e, hyper, **kw)
    if p.device.type == "cpu":
        return adam_ema_plain(g, m, v, p, e, hyper, **kw)
    raise ValueError(f"adam_ema runs on cuda or cpu tensors, got {p.device}")


class Optimizer:
    """Ema(ExponentialDecay(Adam)) over an NGP parameter list
    [hash_table, *density_mlp, *rgb_mlp]: the hash table lazy and without
    L2, the MLP matrices dense with L2; with `flat` every leaf dense with L2
    (create_optimizer_flat). `ema` holds the EMA copies. The two
    counts are the optax chain's: `count` the Adam count (bias corrections),
    `sched_count` the learning-rate schedule's; both are host integers that
    advance by the steps a call ran. Each step's (lr, bc1, bc2) row is
    computed on the host from them (`hyper_rows`) and read by the kernel
    from the card, so the counts advance apart from the update (`apply`,
    then `advance`), and a graph of several steps reads one row each."""

    def __init__(self, cfg: OptimizerConfig, params, ema, flat: bool = False):
        self.cfg = cfg
        self.params = list(params)
        self.ema = list(ema)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.sched_count = 0
        self.flat = flat  # every leaf dense with L2 (create_optimizer_flat)
        self.lazy_hash = not flat and not cfg.adam.optimize_params_when_gradient_is_zero

    @torch.no_grad()
    def load_state(self, mu=None, nu=None, count: int = 0, sched_count: int | None = None):
        """Install Adam moments (lists in the params' order; None = zeros)
        and the counts (the schedule's defaults to the Adam count)."""
        for dst, src in ((self.mu, mu), (self.nu, nu)):
            for d, s in zip(dst, src if src is not None else [None] * len(dst), strict=True):
                d.copy_(s) if s is not None else d.zero_()
        self.count = int(count)
        self.sched_count = int(count if sched_count is None else sched_count)

    def state(self) -> dict:
        """The Adam moments (lists in the params' order) and both counts."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count, "sched_count": self.sched_count}

    def hyper_rows(self, n: int) -> np.ndarray:
        """(n, 3) float32 (lr, bc1, bc2) of the next n steps from the current
        counts, each as one step of the optax chain computes it."""
        a = self.cfg.adam
        rows = np.empty((n, len(HYPER_COLUMNS)), np.float32)
        for k in range(n):
            c = np.float32(self.count + k + 1)
            rows[k] = (
                np.float32(a.learning_rate) * lr_factor(self.sched_count + k, self.cfg),
                np.float32(1.0) - np.power(np.float32(a.beta1), c),
                np.float32(1.0) - np.power(np.float32(a.beta2), c),
            )
        return rows

    def advance(self, n: int):
        self.count += n
        self.sched_count += n

    @torch.no_grad()
    def apply(self, grads, hyper: torch.Tensor):
        """Update params, Adam moments and EMA in place with the step row
        `hyper` ((3,) float32 on the params' device); the counts stay."""
        a = self.cfg.adam
        kw = dict(b1=a.beta1, b2=a.beta2, eps=a.epsilon, decay=self.cfg.ema_decay)
        for i, (g, p, m, v, e) in enumerate(zip(grads, self.params, self.mu, self.nu, self.ema, strict=True)):
            is_hash = i == 0 and not self.flat
            adam_ema(g.contiguous(), m, v, p.data, e.data, hyper, l2=0.0 if is_hash else a.l2_reg, lazy=is_hash and self.lazy_hash, **kw)

    def step(self, grads):
        """One update from the host counts, which then advance by one."""
        self.apply(grads, torch.from_numpy(self.hyper_rows(1)[0]).to(self.params[0].device))
        self.advance(1)


def create_optimizer_flat(cfg: OptimizerConfig, param: torch.Tensor, ema: torch.Tensor) -> Optimizer:
    """The single-leaf optimizer of ngp_tpu's create_optimizer_flat (the
    envmap's, testbed.cu:83-90): dense Adam with L2 on every entry (a zero
    gradient still decays the moments and moves the entry), the config's own
    eps, schedule and EMA decay, and its own two counts and (lr, bc1, bc2)
    row; through the adam_ema kernel on the card."""
    return Optimizer(cfg, [param], [ema], flat=True)
