"""Per-phase wall-time / ray-throughput counters (a copy of `PhaseStats`
from `unislam_tpu/utils/profiling.py`, with its per-frame JSON dump and
text summary).

The SLAM driver feeds a `PhaseStats` when `cfg["profiling"]["enabled"]`
is true. Each timed phase ends in a host fetch of a device scalar (the
tracking uncertainty, the mapping loss), so its wall time includes the
device work.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseStats:
    """Accumulates wall time and ray counts per phase ('tracking',
    'mapping', ...), plus a per-frame series: the driver brackets each frame
    with begin_frame/end_frame, and every phase() that closes inside the
    bracket is also charged to that frame's record."""

    def __init__(self):
        self.time_s: Dict[str, float] = defaultdict(float)
        self.rays: Dict[str, int] = defaultdict(int)
        self.calls: Dict[str, int] = defaultdict(int)
        self.frames: list = []          # [{"idx", "t", "phases", ...}, ...]
        self._cur: Optional[dict] = None
        self._cur_t0 = 0.0

    def begin_frame(self, idx: int):
        self._cur = {"idx": int(idx), "phases": {}}
        self._cur_t0 = time.time()

    def end_frame(self, **extra):
        """Close the frame record; `extra` lands in it verbatim (driver
        state like t_iters / mapped / eviction that explains outliers)."""
        if self._cur is not None:
            cur, self._cur = self._cur, None
            cur["t"] = round(time.time() - self._cur_t0, 4)
            cur.update(extra)
            self.frames.append(cur)

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0):
        """Time a phase (the body ends in a host fetch when its device work
        must count)."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.time_s[name] += dt
            self.rays[name] += rays
            self.calls[name] += 1
            if self._cur is not None:
                ph = self._cur["phases"]
                ph[name] = round(ph.get(name, 0.0) + dt, 4)

    def add_rays(self, name: str, rays: int):
        """Credit rays to a phase after the fact — for phases whose ray
        count is only known once the body ran (mid-frame tracking-iteration
        doubling changes the count inside track_frame)."""
        self.rays[name] += rays

    def dump_frames(self, path: str):
        """Atomically write the per-frame series as JSON (one object with a
        'frames' list; ~100 B a frame)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"frames": self.frames}, f)
        os.replace(tmp, path)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, t in self.time_s.items():
            out[name] = {
                "time_s": round(t, 4),
                "calls": self.calls[name],
                "rays": self.rays[name],
                "rays_per_s": round(self.rays[name] / t, 1) if t else 0.0,
            }
        total_t = sum(self.time_s.values())
        total_r = sum(self.rays.values())
        out["total"] = {
            "time_s": round(total_t, 4),
            "calls": sum(self.calls.values()),
            "rays": total_r,
            "rays_per_s": round(total_r / total_t, 1) if total_t else 0.0,
        }
        return out

    def summary(self) -> str:
        rows = ["phase         time_s   calls        rays      rays/s"]
        for name, r in self.report().items():
            rows.append(f"{name:12s} {r['time_s']:8.2f} {r['calls']:7d} "
                        f"{r['rays']:11d} {r['rays_per_s']:11.1f}")
        return "\n".join(rows)
