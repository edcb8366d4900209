"""The share of the window's frames whose tracking the activated-mapping
trigger extended mid-frame, from the base count of iterations to twice
it: the program's `extended` counter over the window's frames, from
`UniSLAM.iters_run`. With `activated_share` it explains
`track_iters_per_frame` and `map_iters_per_frame`."""


def read(run):
    st = run.get("stats") or {}
    it = st.get("iters", {})
    if "extended" not in it or not st.get("frames"):
        return None
    return it["extended"] / st["frames"]
