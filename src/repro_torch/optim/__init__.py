"""Optimizers of the LM zoo's training path."""
