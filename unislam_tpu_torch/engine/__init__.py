"""Tracking, mapping, keyframes, window selection and the SLAM driver."""
