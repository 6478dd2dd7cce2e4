"""Scale-out: data parallelism over several devices (``mesh.py``,
``distributed.py``) and several trainings as one program, the seed farm
(``seedfarm.py``)."""

from marl_dmfb_tpu_torch.parallel.distributed import (init_distributed,
                                                      launched, spawn)
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, mesh_from_flag,
                                               replicate, shard_rows)

__all__ = ["Mesh", "mesh_from_flag", "shard_rows", "replicate",
           "init_distributed", "launched", "spawn"]
