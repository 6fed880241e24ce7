"""The cascaded occupancy grid (counterpart: ngp_tpu/grid/)."""
