# Frozen copy of ngp_tpu_torch/data/__init__.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
