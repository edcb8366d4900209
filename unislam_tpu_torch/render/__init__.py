"""Differentiable volume rendering."""
