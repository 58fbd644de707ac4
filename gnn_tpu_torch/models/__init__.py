"""Functional core and user-facing models (inference)."""
