"""Multi-process execution: a torch.distributed process group and the
input partitioning.

Counterpart of dragnet_tpu/parallel/distributed.py, which starts
jax.distributed.  Every process runs the same program:

* DN_COORDINATOR (host:port of process 0's rendezvous) /
  DN_NUM_PROCESSES / DN_PROCESS_ID start a `gloo` process group from
  tcp://$DN_COORDINATOR.  Its timeout (TIMEOUT_S, 30 min, torch's own
  gloo default) bounds the rendezvous and every collective, so it is
  set far above any sound wait: a process sits in a collective while
  its peer scans a slower partition or writes the whole index.  A
  dead peer is caught by the caller's deadline, not by this timeout,
* each process scans files[process_id::num_processes], pruned by the
  same strftime/time-bounds logic as a local scan,
* the processes exchange serialized points (cluster.py): host data, so
  gloo carries it.  NCCL would not do: two ranks cannot share one GPU,
  and one card may hold every process.
"""

import datetime
import os

_initialized = False

TIMEOUT_S = 1800.0


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _dist_initialized():
    """Whether a process group exists (started here or by an outer
    launcher); initializes nothing."""
    dist = _dist()
    return dist is not None and dist.is_initialized()


def maybe_initialize():
    """Start the gloo process group when the multi-process environment
    is set.  Returns (num_processes, process_id).  With no coordinator
    configured and no process group started elsewhere it returns (1, 0)
    without touching torch.distributed."""
    global _initialized
    coord = os.environ.get('DN_COORDINATOR')
    if coord and not _initialized and not _dist_initialized():
        nprocs = int(os.environ['DN_NUM_PROCESSES'])
        pid = int(os.environ['DN_PROCESS_ID'])
        _dist().init_process_group(
            'gloo', init_method='tcp://' + coord, world_size=nprocs,
            rank=pid, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _initialized = True

    if not _initialized and not _dist_initialized():
        return (1, 0)
    dist = _dist()
    return (dist.get_world_size(), dist.get_rank())


def barrier(failed=False):
    """Every process reaches this point (the build's completion), saying
    whether it failed there.  Returns whether any process failed, so a
    failure on one process ends every process's command with an error
    instead of a success line on the others."""
    import torch
    dist = _dist()
    flag = torch.tensor([1 if failed else 0], dtype=torch.int64)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def partition_files(files, num_processes, process_id):
    """Deterministic map-phase partitioning of the found file list."""
    return [f for i, f in enumerate(files)
            if i % num_processes == process_id]


def is_output_process():
    """Whether this process prints results (process 0; trivially true
    in a single process).  With no DN_COORDINATOR and no process group
    it answers without initializing anything: the CLI asks on every
    command."""
    if not os.environ.get('DN_COORDINATOR') and not _initialized and \
            not _dist_initialized():
        return True
    _, pid = maybe_initialize()
    return pid == 0
