"""The program's tracking phase time (`PhaseStats`) over the window,
over the tracking iterations it ran (`UniSLAM.iters_run`)."""


def read(run):
    st = run.get("stats")
    if not st or not st["iters"]["track"]:
        return None
    return st["phase_s"]["tracking"] * 1e3 / st["iters"]["track"]
