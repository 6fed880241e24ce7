"""ngp_tpu parameter pytrees (as numpy) -> the port's parameters.

Counterpart: the storage conventions of ngp_tpu/ops/hash_encoding.py:163-177
(hash table stored (L, F, T_pad)), ngp_tpu/testbed.py:276-282 (legacy
(L, T_pad, F) snapshots) and ngp_tpu/ops/mlp.py:22-34 ((in, out) fp32 MLP
matrices). The port keeps the table as (L, T_pad, F), the row-gather layout.
"""

import numpy as np
import torch

from ngp_tpu_torch.ops.hash_encoding import HashGridSpec


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
