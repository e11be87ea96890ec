"""Multi-process initialisation and run sharding.

Counterpart of kalign_tpu/parallel/distributed.py:

  * ``init_distributed`` — a gloo process group over TCP (the
    counterpart of jax.distributed.initialize); after it ``make_mesh``
    builds one mesh over every process's devices, the sharded distances
    and buckets gather their host results to every process, the engine
    "gpu-mesh" aligns a family on that mesh, and engine "auto" counts
    every process's cards (``cards_of_every_process``);
  * ``my_ensemble_runs`` — the static partition of ensemble runs over
    processes: each aligns its share (ensemble.ensemble_worker) and the
    POAR tables merge on one host (``merge_poar_tables``, poar.py).

Only host data crosses processes (the reference's gathers are host-side
too), so two processes may share one card; NCCL is not used.
"""

from typing import List, Optional

import torch.distributed as dist

from kalign_tpu_torch.poar import merge_poar_tables  # noqa: F401


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the gloo process group at coordinator_address ("host:port",
    or a "tcp://" URL) as process process_id of num_processes.  A no-op
    in one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed: a coordinator address and a "
                         "process id are required for several processes")
    url = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def cards_of_every_process() -> int:
    """The CUDA cards visible to every process of the group (one gather
    of the counts), this process's alone without a group."""
    import torch
    cards = torch.cuda.device_count()
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return cards
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, cards)
    return sum(every)


def my_ensemble_runs(n_runs: int, process_id: Optional[int] = None,
                     num_processes: Optional[int] = None) -> List[int]:
    """This process's ensemble runs: k % processes == rank."""
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    return [k for k in range(n_runs) if k % nproc == pid]
