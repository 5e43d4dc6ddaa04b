"""Rendering over several samples and several devices: the device mesh,
the sharded render and gradient step, and the sharded-scene ray ring."""
