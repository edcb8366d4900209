"""What the tracker's and the mapper's graphed iterations share.

`GraphAdam` is torch's Adam, bit for bit, on leaves that live as long as
the graph that steps them: a captured graph cannot take the step's bias
corrections from the host, as torch's Adam does, so they sit in a device
tensor that an eager `advance` fills before each step.

`GraphedIteration` runs one loop iteration as a CUDA graph: the first
iteration on a new key eagerly on a side stream (the warm-up a capture
needs), the next captured there and replayed, every later one replayed.
The subclass names its spans and its counter, takes its eager inputs into
fixed buffers and says what an iteration runs (`run`) and on what key.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional, Sequence, Tuple

import torch

from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.utils import profiling
from unislam_tpu_torch.utils.profiling import span


def leaf_key(tree) -> tuple:
    """What a graph on the tensors of `tree` (nested dicts) depends on:
    each one's path, address, shape, dtype and grad flag."""
    return tuple((path, t.data_ptr(), t.shape, t.dtype, t.requires_grad)
                 for path, t in sharding.tensor_leaves(tree))


class GraphAdam:
    """torch.optim.Adam (no weight decay, no amsgrad) over fixed leaves,
    one learning rate a group, with the numbers of a fresh
    `torch.optim.Adam` at each `restart`. `params[k]` is in group
    `groups[k]`. torch's Adam computes a step's bias corrections on the
    host, from the step count; here `advance` (eager) copies them for the
    next step from a table into `scale`, and `update` (which a graph can
    hold) reads them there; `step` is the two."""

    def __init__(self, params: Sequence[torch.Tensor], groups: Sequence[int],
                 lrs: Sequence[float], betas: Tuple[float, float],
                 steps: int, eps: float = 1e-8):
        self.params, self.groups = list(params), tuple(groups)
        self.betas, self.eps = betas, eps
        device = self.params[0].device
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.t = 0                # steps since the last restart
        self.tables = {}          # lrs -> (steps + 1, group, [bc2 sqrt, step])
        self.scale = torch.zeros(len(lrs), 2, device=device)   # the next step's
        self.lrs, self.steps = tuple(lrs), steps
        self._extend(steps)

    def _extend(self, steps: int) -> None:
        """The table of `lrs` through step `steps`: per group, as torch's
        Adam rounds them to the parameters' f32, sqrt(1 - b2^t) and
        -lr / (1 - b1^t)."""
        b1, b2 = self.betas
        rows = [[[0.0, 0.0]] * len(self.lrs)] + [
            [[(1 - b2 ** t) ** 0.5, (lr / (1 - b1 ** t)) * -1]
             for lr in self.lrs] for t in range(1, steps + 1)]
        self.tables[self.lrs] = profiling.fetch(
            torch.tensor, rows, dtype=torch.float32, device=self.scale.device)

    def restart(self, lrs: Optional[Sequence[float]] = None) -> None:
        """A fresh optimiser (at learning rates `lrs`, if given)."""
        if lrs is not None and tuple(lrs) != self.lrs:
            self.lrs = tuple(lrs)
            if self.lrs not in self.tables:
                self._extend(self.steps)
        torch._foreach_zero_(self.exp_avg + self.exp_avg_sq)
        self.t = 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def advance(self) -> None:
        """The next step's bias corrections into `scale` (eager)."""
        self.t += 1
        if self.t >= len(self.tables[self.lrs]):
            self._extend(2 * self.t)
        self.scale.copy_(self.tables[self.lrs][self.t])

    def step(self) -> None:
        """An eager step, as `torch.optim.Adam.step`."""
        self.advance()
        self.update()

    @torch.no_grad()
    def update(self) -> None:
        """Adam's update at `scale`'s step, in the operation order of
        torch's step on this device: the multi-tensor one on CUDA, which
        adds s * (m / d) in one rounding, the single-tensor one on the
        CPU, which adds (s * m) / d. A leaf without a gradient is left as
        it is, as torch's Adam leaves it."""
        have = [k for k, p in enumerate(self.params) if p.grad is not None]
        if not have:
            return
        params = [self.params[k] for k in have]
        grads = [p.grad for p in params]
        exp_avg = [self.exp_avg[k] for k in have]
        exp_avg_sq = [self.exp_avg_sq[k] for k in have]
        b1, b2 = self.betas
        torch._foreach_lerp_(exp_avg, grads, 1 - b1)
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_addcmul_(exp_avg_sq, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(exp_avg_sq)
        for k, p, m, d in zip(have, params, exp_avg, denom):
            g = self.groups[k]
            d.div_(self.scale[g, :1]).add_(self.eps)
            s = self.scale[g, 1:]
            if p.device.type == "cuda":
                p.addcmul_(m / d, s)
            else:
                p.addcdiv_(m * s, d)


class GraphedIteration:
    """A loop iteration as one CUDA graph, on one CUDA device.

    `launch(key, run)` runs `run()` (no arguments; it returns one tensor)
    for the iteration: on a new key eagerly on a side stream, the next
    time captured there and replayed, and replayed from then on. A graph
    belongs to its key: whatever tells the graph's inputs apart (their
    addresses, shapes, dtypes, grad flags). One graph is replayed: a new
    key retires it, and the next capture takes its memory pool over (the
    allocator lets a capture share a pool only while a graph holds it)
    and drops it. `build.LAUNCHES` counts a replay's kernels as the eager
    iteration counts them: the capture's count is taken back, and every
    replay adds it. The registry counts replayed iterations under
    `counter` and captures under `graph_captures`; the warm-up and the
    capture run inside the span `<role>.capture`, the launch inside
    `<role>.replay`."""

    def __init__(self, device, role: str, counter: str):
        self.device = torch.device(device)
        self.role, self.counter = role, counter
        self.key = None
        self.graph = None
        self.retired = None    # the last key's graph, until a capture
        self.out = None        # the graph's output
        self.launches = None   # build.LAUNCHES of one replay
        self.pool = None
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _on_side_stream(self, fn):
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def _capture(self, run: Callable[[], torch.Tensor]) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = build.LAUNCHES.copy()
        # cuBLAS keeps a workspace a handle and stream (32 MiB on an H100),
        # and the forward and the backward each have a handle: the side
        # stream would hold two more for good. Cleared around the capture,
        # the side stream's are allocated in the graph's pool during it
        # and freed into the pool after, where only the graph uses them;
        # the main stream's are made again at their next product
        torch._C._cuda_clearCublasWorkspaces()

        def capture():
            # not `torch.cuda.graph`, which synchronises the device and
            # empties the allocator's cache first; but as it, no garbage
            # collection inside the capture (a collected graph's teardown
            # there invalidates the capture)
            collecting = gc.isenabled()
            gc.disable()
            graph.capture_begin(pool=self.pool)
            try:
                return run()
            finally:
                graph.capture_end()
                if collecting:
                    gc.enable()
        self.out = self._on_side_stream(capture)
        torch._C._cuda_clearCublasWorkspaces()
        self.launches = build.LAUNCHES - before
        build.LAUNCHES -= self.launches
        self.graph, self.retired = graph, None
        profiling.count("graph_captures")

    def launch(self, key, run: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The iteration's output (a copy: the next replay writes over the
        graph's)."""
        with torch.cuda.device(self.device):
            if key != self.key:
                if self.graph is not None:
                    self.retired = self.graph
                self.graph, self.out, self.key = None, None, key
                with span(self.role + ".capture"):
                    out = self._on_side_stream(run)
            else:
                if self.graph is None:
                    with span(self.role + ".capture"):
                        self._capture(run)
                with span(self.role + ".replay"):
                    self.graph.replay()
                build.LAUNCHES.update(self.launches)
                profiling.count(self.counter)
                out = self.out
            return out.clone()
