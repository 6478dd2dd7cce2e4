"""Process groups for data-parallel training (JAX
``parallel/distributed.py``).

A run over n devices is n processes, one per device, in one
``torch.distributed`` group: NCCL when the ranks are on CUDA, gloo on the
CPU.  Two ways in:

* a launcher started the processes (``torchrun --nproc_per_node n``, which
  sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``): :func:`init_distributed` joins its group.  Callers opt
  in, as JAX ``train.py`` does, through :func:`launched` (a ``WORLD_SIZE``
  above 1, or ``MARL_DMFB_DISTRIBUTED=1``), and a failure to join
  propagates: a run that asked for several processes never falls back to
  one;
* ``train.py --mesh n`` was started alone: :func:`spawn` starts the n ranks
  itself with the ``spawn`` start method (CUDA does not survive ``fork``),
  meeting at a file store in a temporary directory, so that no TCP port
  has to be free.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from marl_dmfb_tpu_torch.parallel.mesh import from_group


def backend_for(device) -> str:
    """NCCL for ranks on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched() -> bool:
    """Whether a launcher asked this process to join a group: a
    ``WORLD_SIZE`` above 1 (torchrun's contract) or
    ``MARL_DMFB_DISTRIBUTED=1``."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or os.environ.get("MARL_DMFB_DISTRIBUTED") == "1")


def init_distributed(device) -> torch.device:
    """Join the launcher's group (``env://``) and return this rank's
    device: ``cuda:LOCAL_RANK`` when ``device`` is CUDA, else the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), init_method="env://")
    return device


def rank_devices(device, n: int) -> list:
    """The devices of ``n`` ranks started on one host: ``cuda:0 ..
    cuda:n-1``, or the CPU for each."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{r}" for r in range(n)]
    return ["cpu"] * n


def spawn(fn: Callable, devices: Sequence[str], backend: str, *args):
    """Run ``fn(mesh, *args)`` in ``len(devices)`` new processes, rank r on
    ``devices[r]``, in one group of ``backend``; wait for all of them.  A
    rank that raises stops the others and the error is raised here.  ``fn``
    and ``args`` are pickled, so ``fn`` is a module-level function.  Each
    rank runs with the caller's intra-op threads divided among the ranks."""
    n = len(devices)
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="marl_dmfb_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank, args=(fn, list(devices), backend,
                         os.path.join(tmp, "store"), threads, args),
            nprocs=n, join=True, start_method="spawn")


def _rank(rank: int, fn, devices, backend, store_path, threads, args):
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=len(devices))
    try:
        fn(from_group(device), *args)
    finally:
        dist.destroy_process_group()
