"""The benchmark's generator, readers' helpers and result."""
