"""Msgpack snapshot loading (the load half).

Counterpart: ngp_tpu/train/snapshot.py:27-37 (_decode_tree) and :76-96
(load_snapshot): the model-config document with a "snapshot" subtree whose
ndarray leaves are {"__nd__": True, dtype, shape, raw bytes}. Decodes to
numpy (the port converts to tensors in models/interop.py). Saving and the
reference (tcnn) interchange format are not ported yet. msgpack is imported
inside load_snapshot: nothing else in the port needs it.
"""

import numpy as np


def decode_tree(tree):
    """Snapshot subtree -> the same structure with numpy ndarray leaves."""
    if isinstance(tree, dict) and tree.get("__nd__"):
        return np.frombuffer(tree["data"], dtype=tree["dtype"]).reshape(tree["shape"])
    if isinstance(tree, dict):
        return {k: decode_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [decode_tree(v) for v in tree]
    return tree


def load_snapshot(path):
    """Returns (config_doc_without_snapshot, snapshot dict with numpy arrays)."""
    import msgpack

    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    snap_raw = doc.pop("snapshot", None)
    if snap_raw is None:
        raise ValueError(f"No 'snapshot' section in {path}")
    if "params_binary" in snap_raw:
        raise NotImplementedError("reference (tcnn-layout) snapshots are not ported yet")
    snap = {
        "params": decode_tree(snap_raw["params"]),
        "ema_params": decode_tree(snap_raw["ema_params"]),
        "density_grid": decode_tree(snap_raw["density_grid"]),
        "grid_step": int(snap_raw.get("grid_step", 0)),
        "i_step": int(snap_raw.get("i_step", 0)),
        "scene_scale": float(snap_raw["scene_scale"]),
        "scene_offset": snap_raw["scene_offset"],
    }
    return doc, snap
