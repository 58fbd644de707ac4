"""Losses, optimizers, checkpoints and TensorBoard event files."""
