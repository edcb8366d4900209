"""The program's span store and counters.

`PhaseStats` started as a copy of the JAX package's phase timer
(`unislam_tpu/utils/profiling.py`: per-phase wall time and ray counts, a
per-frame JSON dump, a text summary) and is now the port's span store:
spans nest, and each keeps its total and its self time (its duration less
the part its child spans cover), by name, by path from the outermost span,
and in the current frame's record.

The layers open spans with the module-level `span(name)`, and every call
on the main path that makes the host wait for the device goes through
`fetch`. Both act on what `installed(stats, counters)` put in place:
`UniSLAM.step_frame` installs its `PhaseStats` (None unless
`cfg["profiling"]["enabled"]`) and its counter registry
(`UniSLAM.iters_run`) for the length of a frame. With no `PhaseStats`
installed, `span` returns one shared no-op context after a single check;
`fetch` counts its call in the registry either way, as `count` counts
the layers' other events. With one installed, each closed span also
adds its host time to the registry's `us.<name>` counter (integer
microseconds), and while `torch.profiler` is recording a span is also a
`record_function("layer:<name>")` event, on the profiler's clock beside
the kernels it launched.

Span names are `<role>.<part>` inside the tracking and mapping loops
(`track.fwd`, `map.bwd`, ...). A name that starts with "." takes the role
of the innermost open span (the part of its name before the first "."), so
the shared renderer's `span(".encode")` reads `track.encode` inside a
tracking iteration and `map.encode` inside a mapping one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

# the loop parts of each role (`tracking` / `mapping` iterations)
LOOP_PARTS = ("iter", "fwd", "sample", "encode", "decode", "composite",
              "loss", "bwd", "allreduce", "opt")
# the graphed tracking and mapping iterations' parts (`engine/tracker.py:
# TrackGraph`, `engine/mapper.py: MapGraph`): the eager draws and ray
# gather, the graph's launch, and a warm-up or capture (which open the
# loop parts inside)
GRAPH_PARTS = tuple(f"{role}.{part}" for role in ("track", "map")
                    for part in ("draw", "replay", "capture"))
# every span the main path opens; `UniSLAM` declares a `us.<name>`
# counter for each
SPANS = (("frame_fetch", "tracking", "mapping", "hooks", "keyframes", "sync",
          "track.init", "map.select", "map.setup", "map.gather")
         + tuple(f"{role}.{part}" for role in ("track", "map")
                 for part in LOOP_PARTS) + GRAPH_PARTS)


class _Span:
    """An open-and-close pair on a `PhaseStats` (a context manager)."""

    __slots__ = ("_stats", "_name", "_rays")

    def __init__(self, stats: "PhaseStats", name: str, rays: int):
        self._stats, self._name, self._rays = stats, name, rays

    def __enter__(self):
        self._stats._open(self._name)
        return self

    def __exit__(self, *exc):
        self._stats._close(self._rays)
        return False


class PhaseStats:
    """Host time, calls and ray counts per span ('tracking', 'mapping',
    'track.fwd', ...), plus a per-frame series: `UniSLAM.step_frame`
    brackets each frame with begin_frame/end_frame, and every span that
    closes inside the bracket is also charged to that frame's record
    ("phases": name -> seconds). Times are on `time.perf_counter_ns`.

    `time_s` / `calls` / `rays` are by span name; `tree` is by path
    ("mapping/map.iter/map.fwd"): [total ns, self ns, calls], so that a
    parent's self time plus its children's totals is its total. A name is
    either always opened inside another span or never (`nested()`);
    `report()["total"]` sums the names that are never nested.
    `counters` (a dict, or None): each span adds its host time to
    `counters["us." + name]` where that key exists."""

    def __init__(self, counters: Optional[dict] = None):
        self.time_s: Dict[str, float] = defaultdict(float)
        self.rays: Dict[str, int] = defaultdict(int)
        self.calls: Dict[str, int] = defaultdict(int)
        self.tree: Dict[str, list] = {}
        self.counters = counters
        self.frames: list = []          # [{"idx", "t", "phases", ...}, ...]
        self._ns: Dict[str, int] = defaultdict(int)
        # open spans, outermost first: [name, path, role, t0 ns, children's
        # ns, record_function or None]
        self._stack: list = []
        self._cur: Optional[dict] = None
        self._cur_t0 = 0

    def begin_frame(self, idx: int):
        self._cur = {"idx": int(idx), "phases": {}}
        self._cur_t0 = time.perf_counter_ns()

    def end_frame(self, **extra):
        """Close the frame record; `extra` lands in it verbatim (driver
        state like t_iters / mapped / eviction that explains outliers)."""
        if self._cur is not None:
            cur, self._cur = self._cur, None
            cur["t"] = round((time.perf_counter_ns() - self._cur_t0) / 1e9, 6)
            cur["phases"] = {k: round(v, 6) for k, v in cur["phases"].items()}
            cur.update(extra)
            self.frames.append(cur)

    def phase(self, name: str, rays: int = 0) -> _Span:
        """A span over the `with` body (the body ends in a host fetch when
        its device work must count). `name` may start with "." (see the
        module note)."""
        return _Span(self, name, rays)

    def _open(self, name: str):
        stack = self._stack
        if name[0] == ".":
            name = stack[-1][2] + name if stack else name[1:]
        path = stack[-1][1] + "/" + name if stack else name
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.autograd.profiler.record_function("layer:" + name)
            rf.__enter__()
        stack.append([name, path, name.partition(".")[0],
                      time.perf_counter_ns(), 0, rf])

    def _close(self, rays: int):
        t1 = time.perf_counter_ns()
        name, path, _, t0, child, rf = self._stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = t1 - t0
        if self._stack:
            self._stack[-1][4] += dt
        node = self.tree.get(path)
        if node is None:
            node = self.tree[path] = [0, 0, 0]
        node[0] += dt
        node[1] += dt - child
        node[2] += 1
        self.time_s[name] += dt / 1e9
        self.rays[name] += rays
        self.calls[name] += 1
        key = "us." + name
        if self.counters is not None and key in self.counters:
            before = self._ns[name]
            self._ns[name] = before + dt
            self.counters[key] += (before + dt) // 1000 - before // 1000
        if self._cur is not None:
            ph = self._cur["phases"]
            ph[name] = ph.get(name, 0.0) + dt / 1e9

    def add_rays(self, name: str, rays: int):
        """Credit rays to a phase after the fact — for phases whose ray
        count is only known once the body ran (mid-frame tracking-iteration
        doubling changes the count inside track_frame)."""
        self.rays[name] += rays

    def dump_frames(self, path: str):
        """Atomically write the per-frame series as JSON (one object with a
        'frames' list; each record holds its frame's spans)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"frames": self.frames}, f)
        os.replace(tmp, path)

    def nested(self) -> set:
        """The names of spans opened inside another span."""
        return {p.rsplit("/", 1)[1] for p in self.tree if "/" in p}

    def report(self) -> Dict[str, Dict[str, float]]:
        own = defaultdict(int)
        for path, node in self.tree.items():
            own[path.rsplit("/", 1)[-1]] += node[1]
        out = {}
        for name, t in self.time_s.items():
            out[name] = {
                "time_s": round(t, 4),
                "self_s": round(own[name] / 1e9 if name in own else t, 4),
                "calls": self.calls[name],
                "rays": self.rays[name],
                "rays_per_s": round(self.rays[name] / t, 1) if t else 0.0,
            }
        nested = self.nested()
        top = [n for n in self.time_s if n not in nested]
        total_t = sum(self.time_s[n] for n in top)
        total_r = sum(self.rays[n] for n in top)
        out["total"] = {
            "time_s": round(total_t, 4),
            "calls": sum(self.calls[n] for n in top),
            "rays": total_r,
            "rays_per_s": round(total_r / total_t, 1) if total_t else 0.0,
        }
        return out

    def summary(self) -> str:
        """The phases (spans never nested) and their total, as the JAX
        package prints them, then the span tree with self times."""
        rows = ["phase         time_s   calls        rays      rays/s"]
        nested = self.nested()
        for name, r in self.report().items():
            if name in nested:
                continue
            rows.append(f"{name:12s} {r['time_s']:8.2f} {r['calls']:7d} "
                        f"{r['rays']:11d} {r['rays_per_s']:11.1f}")
        if nested:
            rows.append("span                              time_s   self_s"
                        "     calls")
            for path in sorted(self.tree):
                total, own, calls = self.tree[path]
                depth = path.count("/")
                label = "  " * depth + path.rsplit("/", 1)[-1]
                rows.append(f"{label:32s} {total / 1e9:8.2f} "
                            f"{own / 1e9:8.2f} {calls:9d}")
        return "\n".join(rows)


# what `installed` put in place: the running frame's span store (None:
# tracing off) and counter registry (None: nothing counts)
_stats: Optional[PhaseStats] = None
_counters: Optional[dict] = None
_NULL = contextlib.nullcontext()


def span(name: str, rays: int = 0):
    """A span on the installed `PhaseStats` (`PhaseStats.phase`), or a
    shared no-op context when none is installed."""
    st = _stats
    if st is None:
        return _NULL
    return st.phase(name, rays)


def fetch(fn, *args, **kwargs):
    """fn(*args, **kwargs): a call that makes the host wait for the device
    (a read back, a copy up from pageable memory), counted in the installed
    registry's "syncs" and timed as a `sync` span."""
    if _counters is not None:
        _counters["syncs"] += 1
    with span("sync"):
        return fn(*args, **kwargs)


def count(key: str, n: int = 1) -> None:
    """Add `n` to the installed registry's counter `key` (declared by the
    registry's owner); nothing when no registry is installed."""
    if _counters is not None:
        _counters[key] += n


@contextlib.contextmanager
def installed(stats: Optional[PhaseStats], counters: Optional[dict]):
    """Make `stats` and `counters` what `span` and `fetch` act on inside
    the `with` body (the previous ones come back after it)."""
    global _stats, _counters
    prev = _stats, _counters
    _stats, _counters = stats, counters
    try:
        yield
    finally:
        _stats, _counters = prev
