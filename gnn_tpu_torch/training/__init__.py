"""Losses and optimizers of the training step."""
