"""Layers of the port (transformer stack for now)."""
