"""Multi-device spatial sharding over a JAX device mesh."""
