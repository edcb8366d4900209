"""The share of the window's mapping iterations that were one CUDA graph
launch: the program's `map_graph` counter (iterations replayed, the
capturing one included) over its `map` counter, both from
`UniSLAM.iters_run`. A warm-up iteration, run eagerly before a capture,
is not replayed."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "map_graph" not in it or not it.get("map"):
        return None
    return it["map_graph"] / it["map"]
