"""The profiled stretch: torch.profiler over whole mapping cycles, reduced
to what the per-layer metrics and the breakdown read.

The harness wraps the program's layer entries in spans of its own
(`record_function` around the tracker's frame loop, the mapping phase,
keyframe selection and insertion, and the frame fetch) for the stretch
only, so an idle gap on the device is named by the layer the host was in
and the innermost host operation running at the gap's middle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
# (attribute path on the UniSLAM object, span name)
SPANS = (("tracker.track_frame", "tracker"), ("mapper.map_phase", "mapper"),
         ("select_fn", "selection"), ("maybe_add_keyframe", "keyframes"),
         ("_frame", "frame_fetch"))


@contextlib.contextmanager
def layer_spans(slam):
    """Wrap each layer entry of SPANS on this instance in a span."""
    undo = []
    for path, name in SPANS:
        *owner_path, attr = path.split(".")
        owner = slam
        for p in owner_path:
            owner = getattr(owner, p)
        fn = getattr(owner, attr)

        def spanned(*a, __fn=fn, __name=name, **k):
            with torch.profiler.record_function(f"layer:{__name}"):
                return __fn(*a, **k)
        # an instance attribute (select_fn) is put back; a method is
        # uncovered by deleting the wrapper
        undo.append((owner, attr, fn if attr in vars(owner) else None))
        setattr(owner, attr, spanned)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, wall_s: float, frames: int, iters: dict,
           top: int = 10) -> dict:
    """What the metrics read from one profile: device seconds and calls
    by kernel name, the union of device activity, launch calls, and the
    breakdown (the device operations that took most time, the longest
    idle gaps summed by what the host was doing)."""
    events = prof.events()
    kernels = defaultdict(lambda: [0.0, 0])
    device, host = [], []
    launches = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation:
                continue
            s, t = e.time_range.start, e.time_range.end
            device.append((s, t))
            k = kernels[e.name]
            k[0] += t - s
            k[1] += 1
        else:
            if e.name in LAUNCH_CALLS:
                launches += 1
            host.append(e)
    busy = _merge(device)
    busy_us = sum(e - s for s, e in busy)
    gaps = defaultdict(float)
    if busy:
        main = _main_thread(host)
        stream = sorted((e for e in host if e.thread == main),
                        key=lambda e: (e.time_range.start, -e.time_range.end))
        stack, p = [], 0
        # a sweep over the gaps in time order: `stack` holds the host
        # events open at the gap's middle, outermost first
        for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
            t = (a + b) / 2
            while p < len(stream) and stream[p].time_range.start <= t:
                ev = stream[p]
                while stack and stack[-1].time_range.end < ev.time_range.start:
                    stack.pop()
                stack.append(ev)
                p += 1
            while stack and stack[-1].time_range.end < t:
                stack.pop()
            gaps[_host_name(stack)] += (b - a) / 1e6
    ops = sorted(((n, us / 1e6) for n, (us, _) in kernels.items()),
                 key=lambda r: -r[1])
    return {"wall_s": wall_s, "busy_s": busy_us / 1e6, "frames": frames,
            "iters": dict(iters), "launches": launches,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "breakdown": {
                "device_ops": [[n[:120], s] for n, s in ops[:top]],
                "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                    key=lambda r: -r[1])[:top]}}


def _main_thread(host) -> int:
    """The thread that issued the launches."""
    counts = defaultdict(int)
    for e in host:
        if e.name in LAUNCH_CALLS:
            counts[e.thread] += 1
    return max(counts, key=counts.get) if counts else 0


def _host_name(stack) -> str:
    """The open host events as '<layer span>/<innermost host op>'
    ('python' where no operation was open: the host ran Python between
    operations)."""
    layer = next((e.name[6:] for e in reversed(stack)
                  if e.name.startswith("layer:")), "none")
    inner = next((e.name for e in reversed(stack)
                  if not e.name.startswith("layer:")), "python")
    return f"{layer}/{inner}"
