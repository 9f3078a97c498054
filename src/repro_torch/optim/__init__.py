"""Optimisers of the port: AdamW (f32 or 8-bit moments) and error-feedback
gradient compression (no JAX)."""
