"""Msgpack snapshots: save and load.

Counterpart: ngp_tpu/train/snapshot.py:17-37 (_encode_tree, _decode_tree),
:40-74 (save_snapshot) and :76-96 (load_snapshot): the model-config document
with a "snapshot" subtree whose ndarray leaves are {"__nd__": True, dtype,
shape, raw bytes}. Arrays go in and come out as numpy in ngp_tpu's layout
(models/interop.py converts), so either package loads the other's
snapshots. Differs: the optimizer state is not serialized (ngp_tpu's
serialize_optimizer=False), and the reference (tcnn) interchange format is
not ported. msgpack is imported inside save/load: nothing else in the port
needs it.
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


def encode_tree(tree):
    """numpy ndarray leaves -> {"__nd__": True, dtype, shape, data} dicts."""
    if isinstance(tree, np.ndarray):
        return {"__nd__": True, "dtype": str(tree.dtype), "shape": list(tree.shape), "data": tree.tobytes()}
    if isinstance(tree, dict):
        return {k: encode_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [encode_tree(v) for v in tree]
    return tree


def save_snapshot(
    path, config_doc: dict, *, params, ema_params, density_grid, grid_step, i_step: int, scene_scale: float, scene_offset, controller=None
):
    """Write the config document with its "snapshot" subtree; params and
    ema_params are numpy pytrees in ngp_tpu's layout (interop.params_to_numpy)."""
    import msgpack

    doc = dict(config_doc)
    snap = {
        "params": encode_tree(params),
        "ema_params": encode_tree(ema_params),
        "density_grid": encode_tree(np.asarray(density_grid, np.float32)),
        "grid_step": int(grid_step),
        "i_step": int(i_step),
        "scene_scale": float(scene_scale),
        "scene_offset": [float(v) for v in scene_offset],
    }
    if controller:
        snap["controller"] = dict(controller)
    doc["snapshot"] = snap
    with open(path, "wb") as f:
        f.write(msgpack.packb(doc, use_bin_type=True))


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
    if "controller" in snap_raw:
        snap["controller"] = dict(snap_raw["controller"])
    return doc, snap
