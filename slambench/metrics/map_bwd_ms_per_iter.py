"""The mapping iterations' backward (the program's `map.bwd` span around
`loss.backward()`, where the host waits on the autograd engine's
thread) in host ms an iteration over the window: `us.map.bwd` over the
mapping iterations, both from `UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.map.bwd" not in it or not it.get("map"):
        return None
    return it["us.map.bwd"] / 1e3 / it["map"]
