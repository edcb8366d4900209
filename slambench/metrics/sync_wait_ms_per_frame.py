"""Host ms a frame spent in the calls that wait for the device over the
window: the program's `sync` span (`profiling.fetch`), its `us.sync`
counter from `UniSLAM.iters_run` over the window's frames."""


def read(run):
    st = run.get("stats") or {}
    it = st.get("iters", {})
    if "us.sync" not in it or not st.get("frames"):
        return None
    return it["us.sync"] / 1e3 / st["frames"]
