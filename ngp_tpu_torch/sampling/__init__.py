"""Lattice ray marching (counterpart: ngp_tpu/sampling/)."""
