"""ngp_tpu parameter pytrees (as numpy) -> the port's parameters.

Counterpart: the storage conventions of ngp_tpu/ops/hash_encoding.py:163-177
(hash table stored (L, F, T_pad)), ngp_tpu/testbed.py:276-282 (legacy
(L, T_pad, F) snapshots) and ngp_tpu/ops/mlp.py:22-34 ((in, out) fp32 MLP
matrices). The port keeps the table as (L, T_pad, F), the row-gather layout.
`training_state_from_numpy` also carries ngp_tpu's training state across
(EMA params, the Adam moments and count of ngp_tpu/train/optimizer.py's
optax chain, the density grid), so both packages can start a step from the
same state; `hash_table_to_numpy` is the way back, for snapshots.
"""

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import GridState, create_grid_state, update_occupancy
from ngp_tpu_torch.ops.hash_encoding import HashGridSpec
from ngp_tpu_torch.utils.config import SamplerConfig


def hash_table_from_numpy(table, spec: HashGridSpec) -> torch.Tensor:
    """(L, F, T_pad) or (L, T_pad, F) array -> (L, T_pad, F) fp32 tensor."""
    t = np.asarray(table, np.float32)
    L, F, T = spec.n_levels, spec.n_features, spec.padded_size
    if t.shape == (L, F, T) and T != F:
        t = t.transpose(0, 2, 1)
    elif t.shape != (L, T, F):
        raise ValueError(f"hash table of shape {t.shape} is neither {(L, F, T)} nor {(L, T, F)}")
    return torch.from_numpy(np.ascontiguousarray(t))


def params_from_numpy(tree: dict, spec: HashGridSpec) -> dict:
    """{hash_table, density_mlp: [...], rgb_mlp: [...]} of numpy arrays ->
    the same dict of CPU fp32 tensors in the port's layout."""
    return {
        "hash_table": hash_table_from_numpy(tree["hash_table"], spec),
        "density_mlp": [torch.from_numpy(np.array(w, np.float32)) for w in tree["density_mlp"]],
        "rgb_mlp": [torch.from_numpy(np.array(w, np.float32)) for w in tree["rgb_mlp"]],
    }


def hash_table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """(L, T_pad, F) tensor -> ngp_tpu's (L, F, T_pad) float32 storage."""
    return np.ascontiguousarray(table.detach().cpu().numpy().transpose(0, 2, 1))


def params_to_numpy(params: dict) -> dict:
    """The port's parameter dict -> ngp_tpu's numpy pytree layout."""
    return {
        "hash_table": hash_table_to_numpy(params["hash_table"]),
        "density_mlp": [w.detach().cpu().numpy() for w in params["density_mlp"]],
        "rgb_mlp": [w.detach().cpu().numpy() for w in params["rgb_mlp"]],
    }


def _leaves(tree: dict, spec: HashGridSpec) -> list:
    p = params_from_numpy(tree, spec)
    return [p["hash_table"], *p["density_mlp"], *p["rgb_mlp"]]


def grid_from_numpy(cfg: SamplerConfig, density, step: int, device="cpu") -> GridState:
    """A density grid (n_cascades * G^3,) and its update counter -> GridState
    with the occupancy bitfield recomputed (testbed.cu:160)."""
    d = torch.from_numpy(np.array(density, np.float32).reshape(-1)).to(device)
    return update_occupancy(cfg, create_grid_state(cfg, device=device)._replace(density=d, step=int(step)))


def training_state_from_numpy(params: dict, ema_params: dict, mu: dict, nu: dict, count: int, spec: HashGridSpec) -> dict:
    """ngp_tpu's training state as numpy pytrees (params, ema_params and the
    Adam mu / nu of its optax state, each {hash_table, density_mlp,
    rgb_mlp}; the Adam count) -> the arguments of Trainer.set_state: params
    and ema as dicts, mu and nu as [hash, *density, *rgb] lists, count."""
    return {
        "params": params_from_numpy(params, spec),
        "ema": params_from_numpy(ema_params, spec),
        "mu": _leaves(mu, spec),
        "nu": _leaves(nu, spec),
        "count": int(count),
    }
