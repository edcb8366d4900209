"""The tracking iterations' forward (the program's `track.fwd` span: the
draws, rays, render and loss) in host ms an iteration over the window:
the span's `us.track.fwd` counter over the tracking iterations, both
from `UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.track.fwd" not in it or not it.get("track"):
        return None
    return it["us.track.fwd"] / 1e3 / it["track"]
