"""The program's mapping phase time (`PhaseStats`) over the window, over
the mapping iterations it ran."""


def read(run):
    st = run.get("stats")
    if not st or not st["iters"]["map"]:
        return None
    return st["phase_s"]["mapping"] * 1e3 / st["iters"]["map"]
