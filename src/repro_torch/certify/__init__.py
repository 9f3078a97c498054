"""Certificate schema (read side)."""
