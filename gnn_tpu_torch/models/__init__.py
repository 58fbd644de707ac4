"""Functional core, user-facing models and the training engine."""
