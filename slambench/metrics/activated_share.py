"""The share of the window's frames whose activated-mapping trigger fired
at the end of tracking: the program's `activated` counter over the
window's frames, from `UniSLAM.iters_run`. Each such frame doubles the
tracking iterations of the next frame and the mapping iterations of the
next phase. With `extended_share` (frames whose tracking the trigger
extended mid-frame) it explains `track_iters_per_frame` and
`map_iters_per_frame`."""


def read(run):
    st = run.get("stats") or {}
    it = st.get("iters", {})
    if "activated" not in it or not st.get("frames"):
        return None
    return it["activated"] / st["frames"]
