"""Pose, ray, sampling and loss math, and explicit random streams."""
