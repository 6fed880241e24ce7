# Frozen copy of ngp_tpu_torch/render/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Frame rendering and the render buffer (counterpart: ngp_tpu/render/)."""
