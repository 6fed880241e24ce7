# Frozen copy of ngp_tpu_torch/train/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Training: the step, the grid update and the optimizer (counterpart: ngp_tpu/train/)."""
