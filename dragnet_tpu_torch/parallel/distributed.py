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
* shutdown() ends the group in order: every process arrives at a
  rendezvous on the group's store, runs one last collective and
  destroys the group; process 0, which hosts the store, returns only
  after every other process has destroyed its own.  Leaving the group
  to interpreter exit let process 1 tear down after process 0's store
  was gone, and abort (SIGABRT) after a sound command,
* each process scans files[process_id::num_processes], pruned by the
  same strftime/time-bounds logic as a local scan,
* the processes exchange serialized points (cluster.py): host data, so
  gloo carries it.  NCCL would not do: two ranks cannot share one GPU,
  and one card may hold every process.
"""

import datetime
import os

_initialized = False
_store = None

TIMEOUT_S = 1800.0

# how long shutdown() waits for every process to arrive: a sound
# command's processes arrive within its output time (process 0 prints
# the merged result while process 1 waits); past it the peer is gone
# or stuck, and the group is destroyed without the last collective
SHUTDOWN_TIMEOUT_S = 300.0
# the same wait after a command failed: a failure every process agreed
# on (the build's failure-flag barrier) brings them all here at once,
# while a failure on one process alone leaves its peers inside a
# collective it will never join; they leave it only once this process
# has destroyed its group
FAILED_SHUTDOWN_TIMEOUT_S = 10.0


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
    global _initialized, _store
    coord = os.environ.get('DN_COORDINATOR')
    if coord and not _initialized and not _dist_initialized():
        nprocs = int(os.environ['DN_NUM_PROCESSES'])
        pid = int(os.environ['DN_PROCESS_ID'])
        host, port = coord.rsplit(':', 1)
        dist = _dist()
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        # the store is held here (process 0 hosts it) so shutdown()
        # can order the teardown through it
        store = dist.TCPStore(host, int(port), nprocs,
                              is_master=(pid == 0), timeout=timeout)
        dist.init_process_group('gloo', store=store, world_size=nprocs,
                                rank=pid, timeout=timeout)
        _store = store
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


def shutdown(orderly=True):
    """End the process group this module started, in order: every
    process arrives at a store rendezvous (so no process is still
    inside a collective of the group), runs one last collective, and
    destroys the group; process 0 then waits until every other process
    has destroyed its own, because they reach its store until then.
    Idempotent; a no-op (returns False) when the group was never
    started here, whether none exists or an outer launcher owns it.
    A peer that does not arrive within SHUTDOWN_TIMEOUT_S, or
    FAILED_SHUTDOWN_TIMEOUT_S when the command failed (`orderly`
    false), gets no last collective: the group is destroyed and this
    process goes on to exit."""
    global _initialized, _store
    if not _initialized:
        return False
    dist = _dist()
    store, _store, _initialized = _store, None, False
    rank, size = dist.get_rank(), dist.get_world_size()
    timeout = datetime.timedelta(seconds=SHUTDOWN_TIMEOUT_S if orderly
                                 else FAILED_SHUTDOWN_TIMEOUT_S)
    mine = 'dn_shutdown/arrived/%d' % rank
    others = [r for r in range(size) if r != rank]
    try:
        store.set(mine, '1')
        store.wait(['dn_shutdown/arrived/%d' % r for r in others],
                   timeout)
        arrived = True
    except RuntimeError:
        arrived = False
        try:
            # a peer arriving later must not take this process for
            # one that will run the last collective
            store.delete_key(mine)
        except RuntimeError:
            pass
    try:
        if arrived:
            barrier()
    except RuntimeError:
        # a peer left at the rendezvous's deadline after all
        arrived = False
    finally:
        dist.destroy_process_group()
        try:
            if arrived and rank != 0:
                store.set('dn_shutdown/destroyed/%d' % rank, '1')
            elif arrived:
                store.wait(['dn_shutdown/destroyed/%d' % r
                            for r in others], timeout)
        except RuntimeError:
            pass
    return True


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
