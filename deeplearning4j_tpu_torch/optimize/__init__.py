"""Optimizers of the port: the gradient transforms (``transforms``)."""
