"""The share of the window's tracking iterations that were one CUDA graph
launch: the program's `track_graph` counter (iterations replayed, the
capturing one included) over its `track` counter, both from
`UniSLAM.iters_run`. A warm-up iteration, run eagerly before a capture,
is not replayed."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "track_graph" not in it or not it.get("track"):
        return None
    return it["track_graph"] / it["track"]
