"""Fault tolerance and straggler mitigation of the port (no JAX)."""
