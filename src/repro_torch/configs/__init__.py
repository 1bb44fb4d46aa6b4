"""Architecture configs of the port (plain data, no JAX)."""
