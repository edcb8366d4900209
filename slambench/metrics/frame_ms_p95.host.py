"""The 95th percentile of `step_frame`'s wall time over every frame of the
window, on the host clock around each call. A per-layer metric: across
seeds it follows how many frames the uncertainty trigger doubles, so its
runs spread too far for an end-to-end bound."""

from slambench.lib import quantile


def read(run):
    return quantile(run["window"]["frame_ms"], 0.95)
