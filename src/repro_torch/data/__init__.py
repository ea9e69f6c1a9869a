"""Deterministic token sources for the LM trainer (numpy only)."""
