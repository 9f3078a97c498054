"""Formats, rounding, scopes and arithmetic backends."""
