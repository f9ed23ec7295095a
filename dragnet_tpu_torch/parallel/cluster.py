"""Cluster datasource: the distributed execution backend.

Counterpart of dragnet_tpu/parallel/cluster.py.  Same public surface as
the file backend (scan, build, index-scan, query), executed over a
device mesh and a process set:

* the record axis of every device batch shards across the mesh's
  devices (MeshDeviceScan: the whole device body per shard, K1 as its
  aggregation, sum/min merges before the fold), and batches the device
  program cannot take aggregate on the host engine, whose dense step is
  sharded too (MeshVectorScan, mesh.sharded_aggregate),
* under a multi-process launch (DN_COORDINATOR et al., distributed.py)
  each process scans its slice of the found files (or of the index
  tree), and the processes exchange their partial aggregates as
  serialized points over gloo, merged in process order: the reduce
  phase.  Every process holds the whole result; process 0 prints it,
* a build merges the tagged partials the same way and process 0 writes
  the index tree, then every process meets at a barrier, reached even
  when the write fails.

The reference warns and aggregates on the host when it finds no usable
accelerator; the port keeps its rule instead: CUDA asked for and absent
raises, and DN_TORCH_DEVICE=cpu runs the mesh on the CPU.
"""

import functools
import json
import os
import time

import numpy as np
import torch

from ..errors import DNError
from ..engine import VectorScan
from ..device_scan import DeviceScan
from .. import datasource_file
from . import mesh as mod_mesh
from . import distributed as mod_dist

# the cross-process exchanges of this process: calls, payload bytes
# sent (lengths and padded points) and seconds inside the collectives
allgather_stats = {'calls': 0, 'bytes': 0, 'seconds': 0.0}


def reset_allgather_stats():
    allgather_stats.update(calls=0, bytes=0, seconds=0.0)


class MeshVectorScan(VectorScan):
    """VectorScan whose dense aggregation runs sharded over the mesh."""

    mesh = None

    def _dense_aggregate(self, key_codes, radices, weights, alive, n):
        codes = np.stack(key_codes)
        return mod_mesh.sharded_aggregate(codes, radices, weights, alive,
                                          mesh=self.mesh)


class MeshDeviceScan(DeviceScan, MeshVectorScan):
    """The cluster backend's scan: eligible batches run the whole device
    body (predicate gathers, date and time-bound masks, bucketize, key
    fusion, the aggregation) on each shard of the mesh, merged by sum
    and by a min over global row indices (first occurrence, the host
    engine's insertion order) before the accumulator fold.  Ineligible
    batches fall through the MRO to MeshVectorScan, whose dense
    aggregation is sharded as well; key spaces past the dense
    accumulator take the host sparse merge (a sparse set has no sum/min
    merge), which the counters show.

    `forced` is the CLI's DN_ENGINE=jax: as in the reference, the host
    engine's sparse-merge threshold for wide key spaces then applies
    only past MAX_DENSE_SEGMENTS.  DN_MESH_PIPELINE=0 turns the sharded
    device body off (one device; the host step stays sharded)."""

    ESCALATE_RECORDS = 0          # cluster mode is explicitly sharded
    REQUIRE_ACCELERATOR = False   # a CPU mesh is a valid target
    STACKABLE = False             # builds fold each metric on its own

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None, mesh=None, forced=True):
        if mesh is None:
            mesh = mod_mesh.make_mesh(device=device)
        DeviceScan.__init__(self, query, time_field, pipeline,
                            ds_filter=ds_filter, device=mesh.devices[0])
        self.mesh = mesh
        if not forced:
            self.agg_device = None
        self.route['mesh'] = self._mesh_key()

    def _device_mesh(self):
        if os.environ.get('DN_MESH_PIPELINE', '1') == '0':
            return None
        return (self.mesh, self.mesh.axis)


class DatasourceCluster(datasource_file.DatasourceFile):
    """File-layout datasource executed over the device mesh and the
    process set.  `mesh` pins the mesh (tests, and two shards on one
    card); by default each scan makes one over the process-local
    devices of the caller's device."""

    def __init__(self, dsconfig, mesh=None):
        datasource_file.DatasourceFile.__init__(self, dsconfig)
        self.mesh = mesh

    def _find(self, root, timeformat, start_ms, end_ms, pipeline):
        files = super(DatasourceCluster, self)._find(
            root, timeformat, start_ms, end_ms, pipeline)
        if isinstance(files, DNError):
            return files
        nprocs, pid = mod_dist.maybe_initialize()
        if nprocs > 1:
            files = mod_dist.partition_files(files, nprocs, pid)
        return files

    def _cached_index_walk(self, root, pipeline):
        """The memoized index-tree walk lists the WHOLE tree; this
        process keeps only its partition, as _find does."""
        files = super(DatasourceCluster, self)._cached_index_walk(
            root, pipeline)
        nprocs, pid = mod_dist.maybe_initialize()
        if nprocs > 1:
            files = mod_dist.partition_files(files, nprocs, pid)
        return files

    def _scan_cls(self, engine, device):
        """Every engine but the per-record one runs MeshDeviceScan, as
        the reference's cluster backend does whatever DN_ENGINE says."""
        mesh = self.mesh if self.mesh is not None else \
            mod_mesh.make_mesh(device=device)
        return functools.partial(MeshDeviceScan, mesh=mesh,
                                 forced=engine == 'device')

    def build(self, metrics, interval, time_after=None, time_before=None,
              dry_run=False, device=None, engine='device', warn_func=None):
        """Distributed index build: every process index-scans its file
        partition (map), the tagged partial aggregates merge across
        processes (reduce), and process 0 writes the index tree."""
        nprocs, pid = mod_dist.maybe_initialize()
        if nprocs <= 1 or dry_run:
            result = super(DatasourceCluster, self).build(
                metrics, interval, time_after=time_after,
                time_before=time_before, dry_run=dry_run, device=device,
                engine=engine, warn_func=warn_func)
            if dry_run:
                result.dry_run_plan = self.execution_plan(
                    result.dry_run_files, device)
            return result

        # the single-process build's argument checks, on every process:
        # failing here beats an error on process 0 and a barrier hang on
        # the rest
        error = self.check_time_args(time_after, time_before)
        if error is None:
            error = self.check_index_args(interval, True, True)
        if error is not None:
            raise error

        # index_scan (below) merges across processes, so every process
        # holds the complete tagged aggregate here
        result = self.index_scan(metrics, interval, filter=self.ds_filter,
                                 time_after=time_after,
                                 time_before=time_before, device=device,
                                 engine=engine, warn_func=warn_func)
        # the barrier must be reached even if the write fails, or every
        # other process waits in it until the group's timeout; it tells
        # every process whether process 0's write failed
        write_err = None
        if pid == 0:
            try:
                self._index_write(metrics, interval, result.points)
            except Exception as e:
                write_err = e
        failed = mod_dist.barrier(failed=write_err is not None)
        if write_err is not None:
            raise write_err
        if failed:
            raise DNError('index write failed on process 0')
        result.points = None
        return result

    def scan(self, query, device=None, engine='device', dry_run=False,
             warn_func=None):
        """Local scan over this process's file partition, then the
        points-level merge across processes.  Merging serialized points
        rather than dense accumulators means per-process string
        dictionaries never need to agree, and it works for every engine
        (device, host, --warnings)."""
        result = super(DatasourceCluster, self).scan(
            query, device=device, engine=engine, dry_run=dry_run,
            warn_func=warn_func)
        if dry_run:
            result.dry_run_plan = self.execution_plan(
                result.dry_run_files, device)
            return result
        nprocs, _ = mod_dist.maybe_initialize()
        if nprocs <= 1 or result.points is None:
            return result
        result.points = _allgather_merge_points(query, result.points)
        return result

    def index_scan(self, metrics, interval, filter=None, time_after=None,
                   time_before=None, device=None, engine='device',
                   warn_func=None):
        """Distributed index-scan: each process scans its file partition,
        then the __dn_metric-tagged partials merge across processes, so
        process 0 prints the whole aggregate, not its partition."""
        result = super(DatasourceCluster, self).index_scan(
            metrics, interval, filter=filter, time_after=time_after,
            time_before=time_before, device=device, engine=engine,
            warn_func=warn_func)
        nprocs, _ = mod_dist.maybe_initialize()
        if nprocs <= 1 or result.points is None:
            return result
        result.points = _allgather_merge_tagged(result.points)
        return result

    def query(self, query, interval, dry_run=False, device=None,
              engine='device'):
        """Distributed index query: each process queries its partition of
        the index files (the _cached_index_walk override) through the
        file backend's query (stacked, on the device lane where the
        engine says so), then the partials merge across processes as a
        scan's do."""
        result = super(DatasourceCluster, self).query(
            query, interval, dry_run=dry_run, device=device, engine=engine)
        if dry_run:
            result.dry_run_plan = self.execution_plan(
                result.dry_run_files, device)
            return result
        nprocs, _ = mod_dist.maybe_initialize()
        if nprocs <= 1 or result.points is None:
            return result
        result.points = _allgather_merge_points(query, result.points)
        return result

    def execution_plan(self, partition_files, device=None):
        """The serializable execution plan (the reference printed its
        Manta job JSON on --dry-run): process topology, this process's
        input partition, the pools and lanes, and the devices of the
        mesh, listed without initializing CUDA."""
        nprocs, pid = mod_dist.maybe_initialize()
        from ..byteparse import parse_mode
        from ..index_build_mt import build_threads
        from ..index_query_mt import iq_threads
        from ..index_query_stack import stack_mode
        plan = {
            'backend': 'cluster',
            'phases': [
                {'type': 'map',
                 'exec': 'scan partition on local device mesh'},
                {'type': 'reduce',
                 'exec': 'allgather points merge across processes'},
            ],
            'nprocesses': nprocs,
            'process': pid,
            'partition': list(partition_files or []),
            'index_query_threads': iq_threads(),
            'index_query_stack': stack_mode(),
            'index_build_threads': build_threads(),
            'parse_mode': parse_mode(),
        }
        # the serve topology module is not ported: a plan run under
        # DN_SERVE_TOPOLOGY says so in-plan, as the reference reports a
        # topology file it cannot load
        topo_path = os.environ.get('DN_SERVE_TOPOLOGY')
        if topo_path:
            plan['serve_topology'] = {
                'path': topo_path,
                'error': 'serve topology is not ported to '
                         'dragnet_tpu_torch'}
        names = self.mesh.names() if self.mesh is not None else \
            mod_mesh.local_device_names(device)
        plan['mesh'] = {'axis': 'd', 'local_devices': names}
        return plan


def _allgather_bytes(payload):
    """Every process's `payload` (bytes), in process order: the lengths
    first, then each payload padded to the longest as uint8, over the
    gloo group."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    nprocs = dist.get_world_size()
    data = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
        if payload else torch.zeros(0, dtype=torch.uint8)
    mylen = torch.tensor([data.numel()], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(nprocs)]
    dist.all_gather(lens, mylen)
    maxlen = max(int(x[0]) for x in lens)
    padded = torch.zeros(maxlen, dtype=torch.uint8)
    padded[:data.numel()] = data
    gathered = [torch.zeros(maxlen, dtype=torch.uint8)
                for _ in range(nprocs)]
    dist.all_gather(gathered, padded)
    allgather_stats['calls'] += 1
    allgather_stats['bytes'] += 8 + maxlen
    allgather_stats['seconds'] += time.perf_counter() - t0
    return [bytes(g[:int(n[0])].numpy()) for g, n in zip(gathered, lens)]


@functools.lru_cache(maxsize=1 << 16)
def _quoted(s):
    from .. import jsvalues as jsv
    return '"' + jsv._json_escape(s) + '"'


def _fields_key(fields):
    """jsvalues.json_stringify(fields), the same string, with the
    escape of each string cached: a build's merge keys millions of
    points whose strings (field names, hosts, urls) repeat."""
    from .. import jsvalues as jsv
    parts = []
    for k, v in fields.items():
        t = type(v)
        if t is str:
            sv = _quoted(v)
        elif t is int and -(1 << 53) <= v <= (1 << 53):
            sv = str(v)
        else:
            sv = jsv.json_stringify(v)
            if sv is None:
                continue
        parts.append(_quoted(str(k)) + ':' + sv)
    return '{' + ','.join(parts) + '}'


def _shared_buckets(procs):
    """The __dn_ts values that more than one process's points carry, or
    None when some point has no integer __dn_ts (an 'all' build)."""
    counts = {}
    for pts in procs:
        seen = set()
        for fields, _ in pts:
            ts = fields.get('__dn_ts')
            if type(ts) is not int:
                return None
            seen.add(ts)
        for ts in seen:
            counts[ts] = counts.get(ts, 0) + 1
    return set(ts for ts, n in counts.items() if n > 1)


def _allgather_merge_tagged(points):
    """Cross-process merge of __dn_metric-tagged aggregated points (the
    index-build reduce): identical (metric, fields) tuples sum their
    weights (already bucket-min encoded, so addition is exact), first
    seen first, in process order.  A point can only meet its twin in
    another process's points under the same __dn_ts (index bucket); a
    point whose bucket no other process has is new and skips the
    key, so a build whose processes hold disjoint days keys nothing."""
    payload = json.dumps([[f, v] for f, v in points]).encode()
    procs = [json.loads(raw.decode()) for raw in _allgather_bytes(payload)]
    shared = _shared_buckets(procs)
    merged = {}
    out = []
    for pts in procs:
        for fields, value in pts:
            if shared is not None and fields['__dn_ts'] not in shared:
                out.append([fields, 0 + value])
                continue
            key = _fields_key(fields)
            ent = merged.get(key)
            if ent is None:
                ent = merged[key] = [fields, 0]
                out.append(ent)
            ent[1] += value
    return [(f, v) for f, v in out]


def _allgather_merge_points(query, points):
    """Exchange each process's partial aggregate as serialized points
    (the commutative-monoid wire format of the reference's map->reduce)
    and re-aggregate in process order.  Every process computes the
    whole result."""
    from ..aggr import Aggregator
    payload = json.dumps([[f, v] for f, v in points]).encode()
    aggr = Aggregator(query)
    for raw in _allgather_bytes(payload):
        for fields, value in json.loads(raw.decode()):
            aggr.write(fields, value)
    return aggr.points()


def create_datasource(dsconfig):
    if not isinstance(dsconfig['ds_backend_config'].get('path'), str):
        return DNError('expected datasource "path" to be a string')
    return DatasourceCluster(dsconfig)
