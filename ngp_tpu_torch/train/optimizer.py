"""Optimizer: lazy Adam + stepped exponential LR decay + parameter EMA.

Counterpart: ngp_tpu/train/optimizer.py:31-39 (lr_factor), :42-95
(scale_by_adam_lazy), :98-135 (create_optimizer: L2 on the MLP matrices
only, the hash table lazy) and :153-155 (ema_update), and
tools/mb22_optfuse.py:56-89, the Pallas kernel that fuses one step of a leaf.
Same counters as the optax chain: the bias corrections use the Adam count
starting at 1, the learning rate the schedule's count starting at 0. Differs:
the state is a plain object updated in place, and every leaf goes through
one fused kernel (csrc/adam_ema.cu) on the card, with `lazy` on for the hash
table and `l2` for the MLP matrices; `adam_ema_plain` is its plain version.
"""

import ctypes

import numpy as np
import torch

from ngp_tpu_torch.ops import kernels
from ngp_tpu_torch.utils.config import OptimizerConfig
from ngp_tpu_torch.utils.fma import sqrt_rn

N_LAUNCHES = 0  # launches of the adam_ema kernel in this process


def lr_factor(step: int, cfg: OptimizerConfig) -> np.float32:
    """Stepped decay factor base^(1 + (step - start) // interval) after start."""
    n = 0 if step < cfg.decay_start else (step - cfg.decay_start) // cfg.decay_interval + 1
    return np.power(np.float32(cfg.decay_base), np.float32(n))


def _hyper(lr, bc1, bc2, b1, b2, eps, decay):
    return dict(
        lr=np.float32(lr), bc1=np.float32(bc1), bc2=np.float32(bc2), b1=np.float32(b1), one_minus_b1=np.float32(1.0 - b1),
        b2=np.float32(b2), one_minus_b2=np.float32(1.0 - b2), eps=np.float32(eps), decay=np.float32(decay),
        one_minus_decay=np.float32(1.0 - decay),
    )


def adam_ema_plain(g, m, v, p, e, *, lr, bc1, bc2, b1, b2, eps, decay, l2=0.0, lazy=False):
    """The kernel's function in plain torch, in place on m, v, p, e (fp32,
    same shape): L2, lazy Adam, the lr step and the EMA, in the kernel's
    order of operations (float32 constants, correctly rounded sqrt). The
    constants live on p's device: torch divides a CUDA tensor by a CPU scalar
    through its reciprocal, which is not IEEE division."""
    hy = _hyper(lr, bc1, bc2, b1, b2, eps, decay)
    h = {k: torch.tensor(float(x), dtype=torch.float32, device=p.device) for k, x in hy.items()}
    if l2 != 0.0:
        g = g + torch.tensor(l2, dtype=torch.float32, device=p.device) * p
    nm = h["b1"] * m + h["one_minus_b1"] * g
    nv = h["b2"] * v + h["one_minus_b2"] * g * g
    upd = (nm / h["bc1"]) / (sqrt_rn(nv / h["bc2"]) + h["eps"])
    if lazy:
        visited = g != 0
        nm, nv = torch.where(visited, nm, m), torch.where(visited, nv, v)
        upd = torch.where(visited, upd, 0.0)
    m.copy_(nm)
    v.copy_(nv)
    p.copy_(p - h["lr"] * upd)
    e.copy_(h["decay"] * e + h["one_minus_decay"] * p)


def _library():
    lib = kernels.library("adam_ema")
    p, f = ctypes.c_void_p, ctypes.c_float
    lib.adam_ema.argtypes = [p, p, p, p, p, ctypes.c_longlong] + [f] * 11 + [ctypes.c_int, p]
    lib.adam_ema.restype = ctypes.c_int
    return lib


def adam_ema_cuda(g, m, v, p, e, *, lr, bc1, bc2, b1, b2, eps, decay, l2=0.0, lazy=False):
    """Launch the fused kernel on the current stream; updates m, v, p, e in place."""
    global N_LAUNCHES
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p), ("e", e)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must be contiguous float32 of p's shape on p's device")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves four elements at a time)")
    hy =_hyper(lr, bc1, bc2, b1, b2, eps, decay)
    err = _library().adam_ema(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(), e.data_ptr(), p.numel(),
        *(float(hy[k]) for k in ("lr", "bc1", "bc2", "b1", "one_minus_b1", "b2", "one_minus_b2", "eps", "decay", "one_minus_decay")),
        float(l2), int(bool(lazy)), torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"adam_ema launch failed: CUDA error {err}")
    N_LAUNCHES += 1


def adam_ema(g, m, v, p, e, **kw):
    """One fused step: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if p.device.type == "cuda":
        return adam_ema_cuda(g, m, v, p, e, **kw)
    if p.device.type == "cpu":
        return adam_ema_plain(g, m, v, p, e, **kw)
    raise ValueError(f"adam_ema runs on cuda or cpu tensors, got {p.device}")


class Optimizer:
    """Ema(ExponentialDecay(Adam)) over an NGP parameter list
    [hash_table, *density_mlp, *rgb_mlp]: the hash table lazy and without
    L2, the MLP matrices dense with L2. `ema` holds the EMA copies."""

    def __init__(self, cfg: OptimizerConfig, params, ema):
        self.cfg = cfg
        self.params = list(params)
        self.ema = list(ema)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # Adam count; the schedule's count equals it before the step
        self.lazy_hash = not cfg.adam.optimize_params_when_gradient_is_zero

    @torch.no_grad()
    def load_state(self, mu=None, nu=None, count: int = 0):
        """Install Adam moments (lists in the params' order; None = zeros)
        and the step count."""
        for dst, src in ((self.mu, mu), (self.nu, nu)):
            for d, s in zip(dst, src if src is not None else [None] * len(dst), strict=True):
                d.copy_(s) if s is not None else d.zero_()
        self.count = int(count)

    def step(self, grads):
        """Apply one update in place: params, Adam moments and EMA."""
        a = self.cfg.adam
        lr = np.float32(a.learning_rate) * lr_factor(self.count, self.cfg)
        self.count += 1
        c = np.float32(self.count)
        bc1 = np.float32(1.0) - np.power(np.float32(a.beta1), c)
        bc2 = np.float32(1.0) - np.power(np.float32(a.beta2), c)
        kw = dict(lr=lr, bc1=bc1, bc2=bc2, b1=a.beta1, b2=a.beta2, eps=a.epsilon, decay=self.cfg.ema_decay)
        with torch.no_grad():
            for i, (g, p, m, v, e) in enumerate(zip(grads, self.params, self.mu, self.nu, self.ema, strict=True)):
                is_hash = i == 0
                adam_ema(
                    g.contiguous(), m, v, p.data, e.data, l2=0.0 if is_hash else a.l2_reg, lazy=is_hash and self.lazy_hash, **kw
                )
