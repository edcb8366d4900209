"""Ray-batch sharding and table-row sharding over a ray group.

Counterpart of `unislam_tpu/parallel/sharding.py`. The JAX package lays a
`('rays',)` mesh over its devices and lets XLA insert the collectives; here
each rank (one process, one device) draws the whole ray batch from the same
seed, keeps its block of rays (`ray_block`, `shard_rays`), and sums its
gradients with the other ranks' (`all_reduce_grads`). Parameters, poses,
optimiser state and the keyframe bank are replicated. With
`parallel.shard_tables` a grid table is the exception: each rank keeps a
block of its rows (`table_row_block`) and builds the full table for a
render through `GatherRows`, whose backward hands each rank its own rows'
summed gradient.

Every collective here is an `all_reduce` or a `broadcast`: a gather is an
all-reduce of a full buffer padded with -0.0 (which keeps every value bit
for bit), a reduce-scatter an all-reduce followed by a slice. Those two
run on gloo (CPU tensors, and CUDA tensors through the host) and on
NCCL. A `group` of None means one rank: every
function is then the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unislam_tpu_torch.parallel.distributed import RayGroup, group_src

RAY_AXIS = "rays"

# grid-table leaf names of both encodings: hash mode's "sdf_table" and
# "color_table", brick mode's one shared "table"
TABLE_KEYS = ("sdf_table", "color_table", "table")


def _block(n: int, rank: int, world: int) -> Tuple[int, int]:
    per = -(-n // world)
    start = min(rank * per, n)
    return start, min(start + per, n)


def ray_block(n: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) of rank `rank`'s rays among `n`: blocks of
    ceil(n / world), the last shorter (XLA's layout of P('rays'))."""
    return _block(n, rank, world)


def table_row_block(n_rows: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) of rank `rank`'s table rows, in `ray_block`'s layout."""
    return _block(n_rows, rank, world)


def group_block(n: int, group: Optional[RayGroup]) -> Tuple[int, int]:
    return (0, n) if group is None else _block(n, group.rank, group.size)


def shard_rays(group: Optional[RayGroup], *tensors):
    """Each tensor's block of rays (leading dimension); the tensors as
    given for `group` None."""
    if group is not None:
        out = []
        for t in tensors:
            a, b = group_block(t.shape[0], group)
            out.append(t[a:b])
        tensors = tuple(out)
    return tensors if len(tensors) > 1 else tensors[0]


def scene_param_layout(params: Dict[str, Any], shard_tables: bool = False):
    """The scene's layout, a tree of "rows" (row-sharded) or "replicated"
    like `params`: a leaf is "rows" only when its key is exactly one of
    TABLE_KEYS and it is 2-D, as `scene_param_shardings` decides."""
    def spec(key, leaf):
        if isinstance(leaf, dict):
            return {k: spec(k, v) for k, v in leaf.items()}
        if shard_tables and key in TABLE_KEYS and leaf.dim() == 2:
            return "rows"
        return "replicated"
    return {k: spec(k, v) for k, v in params.items()}


def sharded_keys(params: Dict[str, Any], shard_tables: bool) -> Tuple[str]:
    """The top-level keys that `scene_param_layout` marks "rows"."""
    layout = scene_param_layout(params, shard_tables)
    return tuple(k for k, v in layout.items() if v == "rows")


# ---------------------------------------------------------------------------
# collectives

def all_reduce_(t: torch.Tensor, group: Optional[RayGroup]) -> torch.Tensor:
    """Sum `t` over the group, in place; returns it."""
    if group is not None:
        dist.all_reduce(t, group=group.pg)
    return t


def all_reduce_sum(t: torch.Tensor,
                   group: Optional[RayGroup]) -> torch.Tensor:
    """The group's sum of `t` (a new tensor, no gradient)."""
    if group is None:
        return t
    return all_reduce_(t.detach().clone(), group)


def gather_rows(block: torch.Tensor, n: int,
                group: Optional[RayGroup]) -> torch.Tensor:
    """The full (n, ...) tensor whose rows `group_block(n, group)` this
    rank holds as `block`: an all-reduce of a full buffer padded with
    -0.0, which every rank's value keeps bit for bit (x + -0.0 is x for
    every x, +0.0 and -0.0 included)."""
    if group is None:
        return block
    a, b = group_block(n, group)
    full = block.new_full((n,) + tuple(block.shape[1:]), -0.0)
    full[a:b] = block.detach()
    return all_reduce_(full, group)


class GatherRows(torch.autograd.Function):
    """A rank's row block -> the full table; the backward sums the full
    table's gradient over the ranks and returns the rank's own rows."""

    @staticmethod
    def forward(ctx, block, n_rows: int, group: RayGroup):
        ctx.n_rows, ctx.group = n_rows, group
        return gather_rows(block, n_rows, group)

    @staticmethod
    def backward(ctx, g):
        a, b = group_block(ctx.n_rows, ctx.group)
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[a:b], None, None


def all_reduce_grads(leaves: Iterable[torch.Tensor],
                     group: Optional[RayGroup],
                     scalars: Optional[torch.Tensor] = None):
    """Sum the gradients of `leaves` over the group, in place, and the
    values `scalars` (a vector, returned summed) with them: one all-reduce
    of their concatenation. A leaf without a gradient takes part with
    zeros (and keeps them), so every rank reduces the same buffer. For
    `group` None, returns `scalars` as given."""
    if group is None:
        return scalars
    leaves = list(leaves)
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    parts = [t.grad.reshape(-1) for t in leaves]
    if scalars is not None:
        parts.append(scalars.detach().reshape(-1).to(parts[0].dtype
                                                     if parts else
                                                     scalars.dtype))
    flat = all_reduce_(torch.cat(parts), group)
    off = 0
    for t in leaves:
        n = t.grad.numel()
        t.grad.copy_(flat[off:off + n].view_as(t.grad))
        off += n
    return None if scalars is None else flat[off:].view_as(scalars)


# ---------------------------------------------------------------------------
# replica checks

def tensor_leaves(tree, prefix: str = ""):
    """(path, tensor) of every tensor in nested dicts, lists, tuples and
    dataclasses, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from tensor_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_leaves(v, f"{prefix}/{i}")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name),
                                     f"{prefix}/{f.name}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns as int64."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype == torch.bool:
        return t.to(torch.int64)
    if t.is_floating_point():
        view = {8: torch.int64, 4: torch.int32, 2: torch.int16}
        return t.view(view[t.element_size()]).to(torch.int64)
    return t.to(torch.int64)


def checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of the bit patterns, plain and weighted by position:
    a change of any bit or of the order moves one of them."""
    b = _bits(t)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) \
        % 65521 + 1
    return torch.stack([b.sum(), (b * w).sum(),
                        torch.tensor(b.numel(), device=b.device)])


def assert_replicas_agree(tree, group: Optional[RayGroup],
                          what: str = "") -> int:
    """Raise on every rank if any tensor of `tree` differs in a bit
    between ranks (rank 0's checksums are broadcast, each rank compares
    its own, and the mismatches are summed so that every rank raises).
    Returns the number of tensors compared. Meant for tests and smoke
    runs, not the hot loop."""
    leaves = list(tensor_leaves(tree))
    if group is None or not leaves:
        return len(leaves)
    # NCCL takes CUDA tensors only; gloo either
    dev = next((t.device for _, t in leaves if t.is_cuda),
               torch.device("cpu"))
    local = torch.stack([checksum(t).to(dev) for _, t in leaves])
    ref = local.clone()
    dist.broadcast(ref, group_src(group, 0), group=group.pg)
    bad = (local != ref).any(dim=1).to(torch.int64)
    all_reduce_(bad, group)
    if bool(bad.any()):
        names = [leaves[i][0] for i in
                 np.nonzero(bad.cpu().numpy())[0].tolist()]
        raise AssertionError(f"replicas differ{' in ' + what if what else ''}"
                             f": {names}")
    return len(leaves)
