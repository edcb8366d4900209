"""Mapping iterations a frame over the window: the cadence's phases,
doubled after a trigger, plus phases on frames that tracking sent
back."""


def read(run):
    st = run.get("stats")
    return st["iters"]["map"] / st["frames"] if st else None
