"""Keyframe work in host ms a frame over the window: the program's
`map.select` span (the window selection and its mask fetch) and its
`keyframes` span (insertion and eviction), their `us.*` counters from
`UniSLAM.iters_run` over the window's frames."""


def read(run):
    st = run.get("stats") or {}
    it = st.get("iters", {})
    keys = ("us.map.select", "us.keyframes")
    if any(k not in it for k in keys) or not st.get("frames"):
        return None
    return sum(it[k] for k in keys) / 1e3 / st["frames"]
