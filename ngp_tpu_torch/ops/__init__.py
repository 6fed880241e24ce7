"""Operators: hash encoding, SH encoding, MLPs, the fused MLP kernel (counterpart: ngp_tpu/ops/)."""
