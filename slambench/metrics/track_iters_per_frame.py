"""Tracking iterations a frame over the window: the base count, raised
where the uncertainty trigger doubles a frame and the ones after it."""


def read(run):
    st = run.get("stats")
    return st["iters"]["track"] / st["frames"] if st else None
