"""Process groups for camera-batch scale-out, port of
`scorp_tpu.parallel.mesh`.

The JAX package shards a batch of cameras over a `jax.sharding.Mesh`; here
each rank is one process on `torch.distributed`:
  * `make_group` starts a group (NCCL for CUDA tensors, gloo for CPU
    tensors) from an explicit TCP store on 127.0.0.1, with a timeout, so
    no environment variable and no launcher is needed. A group of one rank
    is legal;
  * `replicate` broadcasts a state from rank 0 to every rank;
  * `shard_batch` takes the rank's contiguous slice of a batch's leading
    dimension, as the mesh's `data` axis does.
Every function takes `group=None` for one process that holds the whole
batch, which is the unsharded JAX call.
"""

from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class Group:
    """A started process group: this process's rank, the world size and the
    device its tensors live on. `close()` (or leaving a `with` block) tears
    the group down; a rank that leaves without it can hang its peers until
    their timeout."""

    rank: int
    world_size: int
    device: torch.device
    store: dist.TCPStore

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> Group:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_group(world_size: int = 1, rank: int = 0, *, port: int = 0,
               device: str | torch.device = "cuda", timeout: float = 60.0) -> Group:
    """Join (rank > 0) or start (rank 0) a `world_size`-rank group whose
    store listens on 127.0.0.1:`port`. Rank 0 hosts the store; `port=0`
    lets it pick a free port, which only a one-rank group can use (the
    other ranks must know the port beforehand: `free_port()`). The backend
    is NCCL on a CUDA device (one card per rank: `cuda:<rank>` unless
    `device` names one) and gloo on the CPU."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if port == 0 and world_size > 1:
        raise ValueError("a group of several ranks needs an agreed port (free_port())")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a group; close() it first")
    wait = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore("127.0.0.1", port, world_size, rank == 0, timeout=wait)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world_size, timeout=wait)
    return Group(rank, world_size, dev, store)


def _map(fn, tree):
    """`fn` applied to every tensor of a nested structure (dicts, tuples,
    lists, NamedTuples), the structure rebuilt around the results."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def replicate(tree, group: Group | None):
    """Rank 0's tensors on every rank, broadcast in place (every rank must
    pass a tree of the same structure); the tree is returned. Non-tensor
    leaves (e.g. Adam's step) must already agree."""
    if group is None:
        return tree

    def bcast(x):
        dist.broadcast(x, src=0)
        return x

    return _map(bcast, tree)


def shard_batch(tree, group: Group | None):
    """This rank's contiguous slice of the leading (batch) dimension of every
    tensor: rank r of n takes rows [r·B/n, (r+1)·B/n). Raises when B does
    not divide by n, as the JAX sharding does."""
    if group is None:
        return tree
    n, r = group.world_size, group.rank

    def take(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not divide over {n} ranks")
        return x[r * (b // n):(r + 1) * (b // n)]

    return _map(take, tree)
