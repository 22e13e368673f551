"""Optimizers of the training step."""
