"""ngp_tpu_torch — the PyTorch + CUDA (Hopper) port of ngp_tpu.

Counterpart: ngp_tpu/__init__.py. Serving slice: load a model config and a
snapshot, then render Shade/Depth frames; the network's MLP heads run in a
hand-written CUDA kernel (ops/fused_mlp.py) on the card. Imports torch,
numpy and the standard library only, never jax or ngp_tpu.
"""

from ngp_tpu_torch.testbed import (  # noqa: F401
    Activation,
    ColorSpace,
    LossType,
    RenderMode,
    Testbed,
    TonemapCurve,
)
