"""The mapping iterations' forward (the program's `map.fwd` span: the
draws, rays, render with the probe where it runs, and loss) in host ms
an iteration over the window: `us.map.fwd` over the mapping
iterations, both from `UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.map.fwd" not in it or not it.get("map"):
        return None
    return it["us.map.fwd"] / 1e3 / it["map"]
