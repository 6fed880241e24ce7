"""Utilities: config, AABB, colour, QMC, camera, fused multiply-add (counterpart: ngp_tpu/utils/)."""
