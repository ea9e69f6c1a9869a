"""Checkpoints and fault injection for the port's service layer."""
