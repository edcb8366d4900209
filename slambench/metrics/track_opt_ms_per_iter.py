"""The tracking iterations' optimiser (the program's `track.opt` spans:
`zero_grad` and Adam's step) in host ms an iteration over the window:
`us.track.opt` over the tracking iterations, both from
`UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.track.opt" not in it or not it.get("track"):
        return None
    return it["us.track.opt"] / 1e3 / it["track"]
