"""Frames completed in the measured window over the window's wall time
(the window ends in a synchronise, so the last frame's device work is in
it)."""


def read(run):
    w = run["window"]
    return w["n"] / w["wall_s"]
