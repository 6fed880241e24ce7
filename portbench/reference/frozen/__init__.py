"""A frozen copy of the plain path of ngp_tpu_torch (the port), the benchmark's
reference: every kernel replaced by its plain version, the MLP heads on the
mlp_apply chain with the operand rounding that ops/mlp.py's PRECISION
names ("float32" for the reference, "float8" for its control). It imports
nothing of the port, so a change to the port cannot move it."""
