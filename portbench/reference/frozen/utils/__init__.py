# Frozen copy of ngp_tpu_torch/utils/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Utilities: config, AABB, colour, QMC, camera, fused multiply-add (counterpart: ngp_tpu/utils/)."""
