"""Serving layer of the port (generation engine only, for now)."""
