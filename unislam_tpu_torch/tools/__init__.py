"""Evaluation tools."""
