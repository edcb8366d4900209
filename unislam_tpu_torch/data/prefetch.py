"""Background frame prefetcher: decode frame idx+1..idx+ahead while the
device works on frame idx (a copy of `unislam_tpu/data/prefetch.py`).

The driver is frame-sequential, so a 1-worker look-ahead is enough: the
decode of the NEXT frames runs on a host thread while the current frame's
tracking and mapping run on the device. PhaseStats' "frame_fetch" phase
(engine/slam.py) shows whether the IO is off the critical path.

Random access falls back to a direct load (eval tools index arbitrarily).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict


class FramePrefetcher:
    """Wraps any `dataset` with `__getitem__`/`__len__`; sequential access
    is served from a look-ahead queue filled by a background thread."""

    def __init__(self, dataset, ahead: int = 2):
        self._ds = dataset
        self._ahead = max(1, ahead)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="frame-prefetch")
        self._pending: Dict[int, Future] = {}

    def __len__(self) -> int:
        return len(self._ds)

    def _schedule(self, idx: int) -> None:
        if 0 <= idx < len(self._ds) and idx not in self._pending:
            self._pending[idx] = self._pool.submit(self._ds.__getitem__, idx)

    def __getitem__(self, idx: int):
        fut = self._pending.pop(idx, None)
        # keep the queue `ahead` deep past the requested frame
        for j in range(idx + 1, idx + 1 + self._ahead):
            self._schedule(j)
        if fut is not None:
            return fut.result()
        return self._ds[idx]

    def __getattr__(self, name):
        # transparent proxy for dataset attributes (intrinsics, paths, ...)
        return getattr(self._ds, name)

    def close(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False)
