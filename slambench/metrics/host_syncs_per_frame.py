"""Calls a frame that made the host wait for the device (read backs, copies
up from pageable memory) over the window: the program's `syncs` counter
(`UniSLAM.iters_run`, every such call goes through `profiling.fetch`) over
the window's frames."""


def read(run):
    st = run.get("stats") or {}
    it = st.get("iters", {})
    if "syncs" not in it or not st.get("frames"):
        return None
    return it["syncs"] / st["frames"]
