# Frozen copy of ngp_tpu_torch/train/optimizer.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Optimizer: lazy Adam + stepped exponential LR decay + parameter EMA.

Counterpart: ngp_tpu/train/optimizer.py:31-39 (lr_factor), :42-95
(scale_by_adam_lazy), :98-135 (create_optimizer: L2 on the MLP matrices
only, the hash table lazy) and :153-155 (ema_update), and
tools/mb22_optfuse.py:56-89, the Pallas kernel that fuses one step of a leaf.
Same counters as the optax chain: the bias corrections use the Adam count
starting at 1, the learning rate the schedule's count starting at 0; both
are kept, read out (`state`) and installed (`load_state`). Differs:
the state is a plain object updated in place, and every leaf goes through
`adam_ema_plain` (the plain version of the port's fused kernel), with `lazy`
on for the hash table and `l2` for the MLP matrices; the step's learning
rate and bias corrections arrive as a float32 row (`hyper`).
"""

import numpy as np
import torch

from portbench.reference.frozen.utils.config import OptimizerConfig
from portbench.reference.frozen.utils.fma import sqrt_rn

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


def adam_ema(g, m, v, p, e, hyper, **kw):
    """One step in plain torch (frozen copy: no kernel)."""
    return adam_ema_plain(g, m, v, p, e, hyper, **kw)


class Optimizer:
    """Ema(ExponentialDecay(Adam)) over an NGP parameter list
    [hash_table, *density_mlp, *rgb_mlp]: the hash table lazy and without
    L2, the MLP matrices dense with L2. `ema` holds the EMA copies. The two
    counts are the optax chain's: `count` the Adam count (bias corrections),
    `sched_count` the learning-rate schedule's; both are host integers that
    advance by the steps a call ran. Each step's (lr, bc1, bc2) row is
    computed on the host from them (`hyper_rows`) and read by the kernel
    from the card, so the counts advance apart from the update (`apply`,
    then `advance`), and a graph of several steps reads one row each."""

    def __init__(self, cfg: OptimizerConfig, params, ema):
        self.cfg = cfg
        self.params = list(params)
        self.ema = list(ema)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.sched_count = 0
        self.lazy_hash = not cfg.adam.optimize_params_when_gradient_is_zero

    @torch.no_grad()
    def load_state(self, mu=None, nu=None, count: int = 0, sched_count: int | None = None):
        """Install Adam moments (lists in the params' order; None = zeros)
        and the counts (the schedule's defaults to the Adam count)."""
        for dst, src in ((self.mu, mu), (self.nu, nu)):
            for d, s in zip(dst, src if src is not None else [None] * len(dst), strict=True):
                d.copy_(s) if s is not None else d.zero_()
        self.count = int(count)
        self.sched_count = int(count if sched_count is None else sched_count)

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
            is_hash = i == 0
            adam_ema(g.contiguous(), m, v, p.data, e.data, hyper, l2=0.0 if is_hash else a.l2_reg, lazy=is_hash and self.lazy_hash, **kw)
