"""Multi-process alignment: a gloo process group for host control, and
one local mesh a process.

Port of `isaac_aligner_tpu/parallel/multihost.py`.  The JAX package spans
one global (data, shard) mesh over every process, with `shard` inside a
host and `data` across hosts, and feeds it through global arrays
(`put_global`, `to_global_rows`, `fetch_local`).  Across the `data` axis
that program only sums O(10) scalar stats; everything else a host does is
its own.  So here:

- `init_distributed` joins a `torch.distributed` gloo group (the same
  ISAAC_TPU_DIST_COORD / _NPROCS / _PROCID variables; idempotent).  The
  group carries host control only: barriers and int64 stat sums of CPU
  tensors.  No device tensor goes through it, and no NCCL is needed.
- Each process owns its rows (global batch k*P + p of the input stream)
  and its own devices.  With more than one a process (--devices N) they
  form its local mesh (`local_mesh`: one data row), on which it runs the
  sharded drivers (`ShardedAligner`, `ShardedPairedAligner`) unchanged:
  the JAX package's multi-host driver subclasses exist to convert global
  arrays and have no counterpart.  With one device it runs the
  single-device drivers.  Each process thus runs the
  program of a single-process run with the same --devices, which keeps
  the BAM equal to that run's where the SPMD and single-device drivers
  differ (ROADMAP §C4).  The JAX package's global arrays have no
  counterpart.  Processes may share a card (two processes on `cuda:0`).
- Output: every process converts and bins its rows into chunk files named
  by global batch number on the shared Temp/bins; after a barrier process
  0 runs the Build phase over all of them, so the BAM is byte-equal to a
  single-process run with uniform bins.

Each seed tally is counted once: by the process that aligned the batch,
then summed over the processes (`allsum_stats`).  The JAX program already
sums them over its global `data` axis before the workflow sums them
again (ROADMAP §C3).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .sharded import Mesh, make_mesh

#: seconds a barrier or a stat sum waits for the other processes (the
#: slowest process's align phase included)
TIMEOUT_S = 3600


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the gloo process group (idempotent); returns (process id,
    process count).  `coordinator` is process 0's host:port (any free
    port); the arguments default to ISAAC_TPU_DIST_COORD, _NPROCS and
    _PROCID.  Without a process count > 1 there is no group: (0, 1)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("ISAAC_TPU_DIST_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("ISAAC_TPU_DIST_NPROCS", "0"))
    if process_id is None:
        process_id = int(os.environ.get("ISAAC_TPU_DIST_PROCID", "-1"))
    if num_processes <= 1:
        return 0, 1
    if not coordinator or process_id < 0:
        raise ValueError(f"a {num_processes}-process run needs the "
                         f"coordinator host:port and this process's id")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        "gloo", init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def local_mesh(n_devices: int, device="cuda") -> Mesh:
    """This process's mesh: its n devices in one data row (the JAX
    package's local_data=1)."""
    return make_mesh(n_devices, data=1, shard=n_devices, device=device)


def barrier(name: str) -> None:
    """Wait for every process (`name` says which step, for a reader of a
    hung run's traceback)."""
    import torch.distributed as dist

    del name
    dist.barrier()


def allsum_stats(values: dict) -> dict:
    """Sum small per-process integer stats over the processes: one
    all_reduce of one int64 CPU tensor; returns int64 numpy values of the
    inputs' shapes."""
    import torch.distributed as dist

    keys = sorted(values)
    flat = [np.asarray(values[k], np.int64) for k in keys]
    buf = torch.from_numpy(np.concatenate([f.reshape(-1) for f in flat]))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    out, at = {}, 0
    for k, f in zip(keys, flat):
        out[k] = buf[at:at + f.size].numpy().reshape(f.shape)
        at += f.size
    return out

