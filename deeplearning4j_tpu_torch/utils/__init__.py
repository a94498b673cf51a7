"""Helpers of the port: parameter-tree arithmetic (``tree_math``)."""
