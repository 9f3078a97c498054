"""Checkpointing of the port (no JAX)."""
