"""Worker for the port's multi-process cluster tests: runs one cluster
datasource operation of dragnet_tpu_torch under a gloo process group
(DN_COORDINATOR / DN_NUM_PROCESSES / DN_PROCESS_ID) on the CPU, over a
mesh of 4 CPU shards per process, and prints a JSON result line.
Modes, as tests/helpers/cluster_worker.py has them:

    scan DATADIR                 scan + allgather merge -> points
    build DATADIR INDEXDIR       distributed daily index build
    build_fail DATADIR BADPATH   build whose index write fails on
                                 process 0; every process must exit
    build_slow DATADIR INDEXDIR SECONDS
                                 build whose index write on process 0
                                 first sleeps SECONDS, while process 1
                                 waits in the barrier
    query DATADIR INDEXDIR       distributed index query
    index_scan DATADIR           distributed index-scan (merged)

and one of the port's own:

    cli_fail FAILPID ARGS...     the port's CLI on ARGS, whose local
                                 index-scan fails on process FAILPID
                                 alone, while its peer goes on into
                                 the cross-process merge
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

QUERY = {'breakdowns': [
    {'name': 'host'}, {'name': 'latency', 'aggr': 'quantize'}]}

METRIC = {'name': 'm', 'datasource': 'd', 'breakdowns': [
    {'name': 'timestamp', 'field': 'time', 'date': '',
     'aggr': 'lquantize', 'step': 86400},
    {'name': 'host', 'field': 'host'},
    {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]}

SHARDS = 4


def _ds(datadir, indexdir=None):
    from dragnet_tpu_torch.parallel import cluster, mesh
    bc = {'path': datadir, 'timeField': 'time'}
    if indexdir is not None:
        bc['indexPath'] = indexdir
    return cluster.DatasourceCluster({
        'ds_backend': 'cluster',
        'ds_backend_config': bc,
        'ds_filter': None,
        'ds_format': 'json',
    }, mesh=mesh.make_mesh(devices=['cpu'] * SHARDS))


def _cli_fail(failpid, args):
    from dragnet_tpu_torch import cli, datasource_file
    from dragnet_tpu_torch.errors import DNError
    from dragnet_tpu_torch.parallel import distributed

    _, pid = distributed.maybe_initialize()
    if pid == failpid:
        def index_scan(*args, **kwargs):
            raise DNError('planted scan failure on process %d' % pid)
        datasource_file.DatasourceFile.index_scan = index_scan
    return cli.main(args)


def main():
    mode = sys.argv[1]
    if mode == 'cli_fail':
        sys.exit(_cli_fail(int(sys.argv[2]), sys.argv[3:]))
    datadir = sys.argv[2]
    from dragnet_tpu_torch import query as mod_query
    from dragnet_tpu_torch.parallel import distributed

    nprocs, pid = distributed.maybe_initialize()
    out = {'pid': pid, 'nprocs': nprocs}
    kw = {'device': 'cpu', 'engine': 'device'}

    def built_files(indexdir):
        built = []
        for root, dirs, files in os.walk(indexdir):
            for fn in sorted(files):
                built.append(os.path.relpath(os.path.join(root, fn),
                                             indexdir))
        return sorted(built)

    if mode == 'scan':
        result = _ds(datadir).scan(mod_query.query_load(QUERY), **kw)
        out['points'] = result.points
    elif mode == 'build':
        indexdir = sys.argv[3]
        metric = mod_query.metric_deserialize(METRIC)
        _ds(datadir, indexdir).build([metric], 'day', **kw)
        out['built'] = built_files(indexdir)
    elif mode == 'build_slow':
        indexdir, delay = sys.argv[3], float(sys.argv[4])
        metric = mod_query.metric_deserialize(METRIC)
        ds = _ds(datadir, indexdir)
        write = ds._index_write

        def slow_write(*args):
            time.sleep(delay)
            return write(*args)

        ds._index_write = slow_write
        ds.build([metric], 'day', **kw)
        out['built'] = built_files(indexdir)
    elif mode == 'build_fail':
        badpath = sys.argv[3]
        metric = mod_query.metric_deserialize(METRIC)
        try:
            _ds(datadir, badpath).build([metric], 'day', **kw)
            out['error'] = None
        except Exception as e:
            out['error'] = '%s: %s' % (type(e).__name__, e)
    elif mode == 'index_scan':
        metric = mod_query.metric_deserialize(METRIC)
        result = _ds(datadir).index_scan([metric], 'day', **kw)
        out['points'] = result.points
    elif mode == 'query':
        indexdir = sys.argv[3]
        result = _ds(datadir, indexdir).query(
            mod_query.query_load(QUERY), 'day', **kw)
        out['points'] = result.points
    else:
        raise SystemExit('unknown mode %r' % mode)

    print(json.dumps(out))
    sys.stdout.flush()
    distributed.shutdown()


if __name__ == '__main__':
    main()
