"""Multi-process wiring: the `torch.distributed` process group and the
ray groups over it.

Counterpart of `unislam_tpu/parallel/distributed.py`. The JAX package runs
one controller per host over a global device mesh; PyTorch's idiom is one
process per device, so here a rank is one process on one device, and the
ranks of a run form one process group. Nothing on a machine tells a
program of a cluster: the address, the world size and the rank come from
the arguments or from the environment contract of the JAX package:

    UNISLAM_COORDINATOR   host:port of rank 0        (e.g. 10.0.0.2:8476)
    UNISLAM_NUM_PROCESSES total process count
    UNISLAM_PROCESS_ID    this process's rank

Rank r runs on cuda:(r % cards on its host): ranks are laid out a host
after another, each host with the same number of cards.

The backend follows the device: gloo for the CPU, NCCL for CUDA. Ranks
that share one card must take gloo (NCCL refuses two ranks on one GPU);
gloo runs `all_reduce` and `broadcast` on CUDA tensors through the host.
Every collective of the port is one of those two (`parallel/sharding.py`),
so both backends run it.

The overlapped driver over N >= 2 ranks (`engine/overlap.py`) splits the
run by role (`overlap_groups`): rank 0 tracks, ranks 1..N-1 map as one
ray group, rank 1 sends the map snapshot to rank 0 over a group of the
two, and the tracking rank's per-frame records go to every rank over a
gloo group (they are CPU tensors, which NCCL does not take).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


class RayGroup(NamedTuple):
    """A process group over which the ray batch is split, with this
    process's rank in it and its size. `None` in its place means one rank."""
    pg: Any
    rank: int
    size: int


class HostGroups(NamedTuple):
    """The (hosts, rays) layout: `ranks[h]` are host h's ranks, `host` this
    process's host and `local` the ray group of its host's ranks."""
    ranks: np.ndarray
    host: int
    local: RayGroup


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        backend: Optional[str] = None,
                        device=None, timeout=TIMEOUT) -> int:
    """Create the process group from the arguments or the UNISLAM_*
    variables; returns this process's rank. With none of them set it
    creates nothing and returns 0; a second call is a no-op. `backend`
    defaults to NCCL when `device` (default: CUDA if present) is CUDA, else
    gloo. A collective that waits longer than `timeout` fails."""
    coordinator = coordinator or os.environ.get("UNISLAM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("UNISLAM_NUM_PROCESSES", "0")) \
            or None
    if process_id is None:
        pid = os.environ.get("UNISLAM_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator is None and num_processes is None:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number "
                         "of processes and this process's id (UNISLAM_"
                         "COORDINATOR, UNISLAM_NUM_PROCESSES, UNISLAM_"
                         "PROCESS_ID)")
    if backend is None:
        dev = torch.device(device if device is not None else
                           "cuda" if torch.cuda.is_available() else "cpu")
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    return dist.get_rank()


def global_ray_group() -> Optional[RayGroup]:
    """Every rank of the run (the counterpart of `global_ray_mesh`), or
    None when no process group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return RayGroup(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


def host_ray_groups(ranks_per_host: Optional[int] = None
                    ) -> Optional[HostGroups]:
    """The (hosts, rays) layout as per-host sub-groups (the counterpart of
    `host_ray_mesh`), or None when no process group exists. Every rank
    must call it (creating a group is a collective). `ranks_per_host`
    defaults to the cards of this host, at most the world size."""
    world = global_ray_group()
    if world is None:
        return None
    per = ranks_per_host or min(max(torch.cuda.device_count(), 1),
                                world.size)
    if world.size % per:
        raise ValueError(f"{world.size} ranks do not split into hosts of "
                         f"{per}")
    ranks = np.arange(world.size).reshape(-1, per)
    groups = [dist.new_group([int(r) for r in row], timeout=TIMEOUT)
              for row in ranks]
    host = world.rank // per
    return HostGroups(ranks, host, RayGroup(groups[host], world.rank % per,
                                            per))


class OverlapGroups(NamedTuple):
    """The process groups of the overlapped driver (`overlap_groups`).
    `map` is the mapping ray group on a mapping rank when the mapping side
    has two or more ranks, else None (the tracking rank, or one mapping
    rank); `snapshot` is the group of ranks 0 and 1; `records` a gloo
    group of every rank."""
    map: Optional[RayGroup]
    snapshot: Any
    records: Any
    rank: int          # this process's global rank
    world: int


def overlap_groups(timeout=TIMEOUT) -> Optional[OverlapGroups]:
    """The groups of a run of N >= 2 ranks with rank 0 tracking and ranks
    1..N-1 mapping, or None when no such process group exists. Every rank
    creates every group, in one order (creating a group is a collective),
    each with `timeout`, so a lost peer fails the run instead of hanging
    it."""
    world = global_ray_group()
    if world is None or world.size < 2:
        return None
    n, r = world.size, world.rank
    map_pg = dist.new_group(list(range(1, n)), timeout=timeout)
    snap_pg = dist.new_group([0, 1], timeout=timeout)
    rec_pg = dist.new_group(list(range(n)), timeout=timeout,
                            backend="gloo")
    group = RayGroup(map_pg, r - 1, n - 1) if r >= 1 and n > 2 else None
    return OverlapGroups(group, snap_pg, rec_pg, r, n)


def global_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def rank_device() -> torch.device:
    """This rank's card: cuda:(rank % cards on the host)."""
    return torch.device("cuda", global_rank() % torch.cuda.device_count())


def replicate(tree, group: Optional[RayGroup]):
    """Broadcast every tensor of `tree` (nested dicts, lists, tuples,
    dataclasses) from rank 0, in place, and return the tree: the contract
    that every process holds the same values is enforced, not assumed.
    A no-op for `group` None."""
    if group is None:
        return tree
    from unislam_tpu_torch.parallel.sharding import tensor_leaves
    with torch.no_grad():
        for _, t in tensor_leaves(tree):
            dist.broadcast(t, group_src(group, 0), group=group.pg)
    return tree


def group_src(group: RayGroup, rank: int) -> int:
    """The global rank of `group`'s rank `rank` (broadcast takes global
    ranks)."""
    if group.pg is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group.pg, rank)


def fetch_replicated(t) -> np.ndarray:
    """The local copy of a replicated tensor, as numpy."""
    return t.detach().cpu().numpy()
