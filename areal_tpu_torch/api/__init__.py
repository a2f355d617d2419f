"""Data and algorithm API contracts of the port (copies of the JAX package's)."""
