"""Data parallelism over several devices: the env batch and the replay ring
split by rows across ranks, parameters replicated (JAX
``parallel/mesh.py``).

The JAX package lays a 1-D device mesh over its chips and lets XLA insert
the collectives.  Here each device is a process of a ``torch.distributed``
group (NCCL on CUDA, gloo on the CPU), and the port calls the collectives
itself.  :class:`Mesh` names a process's place in that group; rank r holds
rows ``[r*R/n, (r+1)*R/n)`` of every batch-leading array of R rows that
tiles the mesh (:func:`shard_rows`), and a whole copy of anything else.

Only two collectives are used, ``all_reduce`` and ``broadcast``, which both
backends take for CUDA tensors.  Rows that live on other ranks travel by
:func:`gather_rows`: every rank writes the rows it holds into a zeroed byte
buffer of all rows and the buffers are summed, so that each row arrives
bitwise from its one owner whatever its dtype.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AUTO, OFF = "auto", "off"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process's place in a data-parallel group: ``size`` ranks, this one
    ``rank``, on ``device``; ``group`` is the process group (None: the
    default one)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n``: ``[r*n//size, (r+1)*n//size)``, equal
        shares where ``n`` tiles the mesh."""
        return slice(self.rank * n // self.size,
                     (self.rank + 1) * n // self.size)


def from_group(device) -> Mesh:
    """The mesh of the initialized default process group, whatever its
    size, this process on ``device``."""
    return Mesh(size=dist.get_world_size(), rank=dist.get_rank(),
                device=torch.device(device), group=dist.group.WORLD)


def requested_size(flag: str) -> Optional[int]:
    """The device count ``--mesh`` asks for: None for ``auto`` (whatever the
    process group has), 1 for ``off`` or a count below 2, else the count."""
    flag = (flag or AUTO).lower()
    if flag == AUTO:
        return None
    if flag == OFF:
        return 1
    return max(1, int(flag))


def auto_size(device) -> int:
    """The ranks that ``--mesh auto`` starts in a process that no launcher
    started: every visible card when ``device`` is CUDA and more than one
    is visible (JAX shards over all of ``jax.devices()``), else 1.  The
    CPU counts as one device here, as JAX's CPU platform shows one."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return torch.cuda.device_count()
    return 1


def visible_devices(device) -> int:
    """Devices that ranks on ``device``'s type can take: the CUDA cards, or
    the CPU's cores."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def check_visible(n: int, device) -> None:
    """Raise ``ValueError`` when ``n`` ranks do not fit the visible devices
    (JAX ``mesh_from_flag``)."""
    have = visible_devices(device)
    if n > have:
        raise ValueError(f"--mesh={n} but only {have} devices are visible")


def mesh_from_flag(flag: str, device) -> Optional[Mesh]:
    """Resolve ``--mesh`` in a process (JAX ``mesh_from_flag``):

    * ``off`` (or a count below 2): no mesh;
    * ``auto``: the process group when one with more than one rank is up,
      else no mesh (``train.py`` starts one rank a card first where several
      cards are visible, :func:`auto_size`);
    * ``<n>``: the process group, which must have n ranks (``train.py``
      starts them when it was launched alone)."""
    n = requested_size(flag)
    if n == 1:
        return None
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if n is None:
        return from_group(device) if world > 1 else None
    if world != n:
        raise ValueError(
            f"--mesh={n} needs {n} processes and this one is in a group of "
            f"{world}: launch with torchrun --nproc_per_node {n}, or let "
            "train.py start the ranks")
    return from_group(device)


def shard_rows(mesh: Optional[Mesh], tree):
    """This rank's rows of every tensor of ``tree`` (dicts, NamedTuples,
    tensors) whose first axis tiles the mesh; other leaves stay whole (JAX
    ``shard_batch`` replicates them).  No mesh: ``tree`` itself."""
    if mesh is None:
        return tree

    def take(x):
        if (isinstance(x, torch.Tensor) and x.dim() >= 1
                and x.shape[0] % mesh.size == 0):
            return x[mesh.rows(x.shape[0])]
        return x

    return _map(take, tree)


def tile_rows(mesh: Mesh, tree):
    """``tree`` with its rows repeated ``mesh.size`` times, so that this
    rank's rows of the result are ``tree``: a stand-in of the global batch
    for a function that works row by row."""
    return _map(lambda x: x.repeat(mesh.size, *[1] * (x.dim() - 1)), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


@torch.no_grad()
def replicate(mesh: Optional[Mesh], tree):
    """Broadcast rank 0's values of a module's parameters and buffers, or
    of a dict of tensors, to every rank, in place; returns ``tree`` (None
    stays None)."""
    if mesh is None or tree is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []
        _map(tensors.append, tree)
    for t in tensors:
        dist.broadcast(t.data, group=mesh.group, group_src=0)
    return tree


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (``x`` is summed in place and
    returned); no mesh: ``x``."""
    if mesh is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


def gather_rows(mesh: Mesh, fields: dict, owned: torch.Tensor) -> dict:
    """Every rank's rows of ``fields`` (each a tensor of R rows, the same
    shapes on every rank) where ``owned`` (R,) bool marks the rows this rank
    holds: each row comes bitwise from the one rank that holds it.  The
    rows travel as bytes in one ``all_reduce``: a rank writes the bytes of
    its rows into zeros, and the sum of one value and zeros is that value."""
    R = owned.shape[0]
    cols, layout = [], []
    for k, v in fields.items():
        b = v.contiguous().view(R, -1).view(torch.uint8)
        cols.append(b)
        layout.append((k, v.dtype, v.shape, b.shape[1]))
    buf = torch.cat(cols, dim=1)
    buf *= owned.to(torch.uint8)[:, None]
    all_reduce_sum(mesh, buf)
    out, at = {}, 0
    for k, dtype, shape, width in layout:
        out[k] = buf[:, at:at + width].contiguous().view(dtype).view(shape)
        at += width
    return out


def gather_shards(mesh: Mesh, fields: dict) -> dict:
    """The global arrays of which ``fields`` (each this rank's rows, the
    same shapes on every rank) are the shards, rows in rank order."""
    first = next(iter(fields.values()))
    n = first.shape[0] * mesh.size
    mine = mesh.rows(n)
    owned = torch.zeros(n, dtype=torch.bool, device=first.device)
    owned[mine] = True
    padded = {}
    for name, v in fields.items():
        padded[name] = v.new_zeros((n, *v.shape[1:]))
        padded[name][mine] = v
    return gather_rows(mesh, padded, owned)
