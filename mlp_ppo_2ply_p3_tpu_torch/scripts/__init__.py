"""Measurement scripts of the port (twins of the repo's ``scripts/``)."""
