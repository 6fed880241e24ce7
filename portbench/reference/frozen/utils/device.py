# Frozen copy of ngp_tpu_torch/utils/device.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""The device an entry point of the port runs on.

Counterpart: none in ngp_tpu (JAX places arrays on its default backend).
The port's constructors and loaders run on the card unless the caller asks
for the CPU: None means CUDA, and asking for CUDA where there is none raises
instead of falling back to the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """None means the card; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
