# Frozen copy of ngp_tpu_torch/ops/mlp.py at commit ef1215de9ec9, the plain path only: the benchmark's reference.
"""Bias-free MLPs for the NGP heads, with ngp_tpu's bf16 numerics.

Counterpart: ngp_tpu/ops/mlp.py:22-63 (mlp_init, mlp_apply). Same chain
I->N, (H-1)x(N->N), N->O, no biases, activation after every layer but the
last. Numerics: bf16 operands, fp32 accumulation, fp32 activations, re-cast
to bf16 between layers. Differs in how the product is taken: torch.matmul on
two bf16 tensors rounds its RESULT to bf16, so the product runs in fp32 on
bf16-rounded operands (each product of two bf16 values is exact in fp32,
matching jnp.dot(..., preferred_element_type=float32)). On the card this
relies on TF32 being off for fp32 matmuls, which `exact_fp32_matmul` sets.
"""

import math

import torch


def exact_fp32_matmul():
    """Keep fp32 matmuls in full fp32 on the card (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp_init(generator: torch.Generator, n_input: int, n_neurons: int, n_output: int, n_hidden_layers: int):
    """Xavier-uniform init; fp32 (in, out) matrices on the generator's device."""
    dims = [n_input] + [n_neurons] * n_hidden_layers + [n_output]
    weights = []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=generator, device=generator.device)
        weights.append(u * (2.0 * bound) - bound)
    return weights


def activate(x: torch.Tensor, name: str) -> torch.Tensor:
    name = name.lower()
    if name == "none":
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "logistic":
        return torch.sigmoid(x)
    if name == "exponential":
        return torch.exp(x)
    raise ValueError(f"Unknown activation: {name}")


# the operands' precision of every MLP product: "float32" (the reference:
# no rounding) or "float8" (e4m3, the control one precision below the
# port's bf16)
PRECISION = {"name": "float32"}
_ROUND_DTYPES = {"float8": torch.float8_e4m3fn}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to PRECISION (nearest even) and return as fp32; the gradient
    passes straight through the rounding."""
    dtype = _ROUND_DTYPES.get(PRECISION["name"])
    if dtype is None:
        return x
    return x + (x.detach().to(dtype).to(torch.float32) - x.detach())


def mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """PRECISION(a) @ PRECISION(w) accumulated in fp32."""
    return torch.matmul(bf16_round(a), bf16_round(w))


def mlp_apply(weights, x: torch.Tensor, activation: str = "ReLU", output_activation: str = "None") -> torch.Tensor:
    """x: (..., n_input) fp32 -> (..., n_output) fp32."""
    h = x
    for i, w in enumerate(weights):
        h = mm_bf16(h, w)
        last = i == len(weights) - 1
        h = activate(h, output_activation if last else activation)
    return h
