"""Snapshots (the load half; training is not ported yet) (counterpart: ngp_tpu/train/)."""
