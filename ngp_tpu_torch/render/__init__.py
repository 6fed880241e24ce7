"""Frame rendering and the render buffer (counterpart: ngp_tpu/render/)."""
