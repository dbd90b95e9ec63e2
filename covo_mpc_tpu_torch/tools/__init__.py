"""Chip-only measurement tools of the port (not imported by the package)."""
