"""The tracking iterations' backward (the program's `track.bwd` span
around `loss.backward()`, where the host waits on the autograd engine's
thread) in host ms an iteration over the window: `us.track.bwd` over
the tracking iterations, both from `UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.track.bwd" not in it or not it.get("track"):
        return None
    return it["us.track.bwd"] / 1e3 / it["track"]
