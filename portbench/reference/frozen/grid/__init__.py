# Frozen copy of ngp_tpu_torch/grid/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""The cascaded occupancy grid (counterpart: ngp_tpu/grid/)."""
