"""Data for the port (no JAX)."""
