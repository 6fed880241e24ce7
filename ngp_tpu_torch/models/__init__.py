"""The NGP model and parameter interchange with ngp_tpu (counterpart: ngp_tpu/models/)."""
