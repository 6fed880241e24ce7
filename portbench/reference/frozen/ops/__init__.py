# Frozen copy of ngp_tpu_torch/ops/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Operators: hash encoding, SH encoding, MLPs, sample layout, losses (counterpart: ngp_tpu/ops/)."""
