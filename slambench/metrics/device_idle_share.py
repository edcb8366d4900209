"""The share (%) of the profiled stretch's wall time in which no kernel,
copy or memset ran on the card (the union of the trace's device
intervals is the busy time)."""


def read(run):
    tr = run.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"]) if tr else None
