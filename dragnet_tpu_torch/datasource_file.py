"""File-backend scan, build, index-scan and query: input enumeration,
the native parse stream, the scan engines and the index walk.

Counterpart of dragnet_tpu/datasource_file.py (`scan`, `build`,
`index_scan`, `query`), restricted to the native-parser lane
(native/dnparse.cc) and its single-threaded engine step: input
enumeration (strftime-pruned when the datasource has a time format),
one pass over the concatenated file bytes (a partial trailing line
joins across file boundaries), batches fed to the device scan
(device_scan.py) or, when asked for, the host engine
(engine.VectorScan).  A build feeds ONE parse stream to every metric's
scan (stacked on the device: DeviceScanStack) and hands each metric's
aggregate to the index writer (index_build_mt.py).  A query walks the
index tree and answers through the rollup planner, the stacked path
(index_query_stack.py, its weight sums on the device: device_index.py)
or the per-shard loop (index_query_mt.py), in the reference's order.
"""

import os

import numpy as np

from .errors import DNError
from . import log as mod_log
from . import ingest as mod_ingest
from . import find as mod_find
from . import native as mod_native
from . import query as mod_query
from .aggr import Aggregator
from .engine import BATCH_SIZE, NativeColumns, VectorPredicate, VectorScan
from .ops.kernels import TRUE
from .vpipe import Pipeline

ENGINES = ('device', 'vector')

LOG = mod_log.get('datasource-file')


def create_datasource(dsconfig):
    assert dsconfig['ds_backend'] == 'file'
    if not isinstance(dsconfig['ds_backend_config'].get('path'), str):
        return DNError('expected datasource "path" to be a string')
    return DatasourceFile(dsconfig)


class ScanResult(object):
    def __init__(self, pipeline, points=None, dry_run_files=None):
        self.pipeline = pipeline
        self.points = points
        self.dry_run_files = dry_run_files


class DatasourceFile(object):
    def __init__(self, dsconfig):
        bc = dsconfig['ds_backend_config']
        self.ds_format = dsconfig.get('ds_format')
        self.ds_timeformat = bc.get('timeFormat')
        self.ds_timefield = bc.get('timeField')
        self.ds_datapath = bc['path']
        self.ds_indexpath = bc.get('indexPath')
        self.ds_filter = dsconfig.get('ds_filter')

    # -- input enumeration ------------------------------------------------

    def _find(self, root, timeformat, start_ms, end_ms, pipeline):
        """Returns list of (path, stat) or DNError."""
        if end_ms is None:
            return mod_find.find_walk([root], pipeline)
        assert start_ms is not None
        pathenum = mod_find.create_path_enumerator(
            os.path.join(root, timeformat), start_ms, end_ms)
        if isinstance(pathenum, DNError):
            return pathenum
        roots = pathenum.paths()
        return mod_find.find_walk(roots, pipeline, pathenum=pathenum)

    def _scan_init(self, time_after, time_before, pipeline):
        """Format check and file list.  Returns (files, fmt) or
        DNError.  (Record-level filtering happens in the engine.)"""
        if self.ds_timefield is None and \
                (time_before is not None or time_after is not None):
            return DNError('datasource is missing "timefield" for '
                           '"before" and "after" constraints')

        fmt = mod_ingest.parser_for(self.ds_format)
        if isinstance(fmt, DNError):
            return fmt

        if self.ds_timeformat is not None:
            files = self._find(self.ds_datapath, self.ds_timeformat,
                               time_after, time_before, pipeline)
        else:
            if time_before is not None or time_after is not None:
                import sys
                sys.stderr.write('warn: datasource is missing '
                                 '"timeformat" for "before" and "after" '
                                 'constraints\n')
            files = self._find(self.ds_datapath, None, None, None, pipeline)
        if isinstance(files, DNError):
            return files
        return (files, fmt)

    # -- scan -------------------------------------------------------------

    def scan(self, query, device=None, engine='device'):
        """Scan raw data to execute a query.  Returns a ScanResult whose
        points are the aggregated output.  engine='device' runs the
        device scan on `device` (CUDA unless the caller asks for the
        CPU); engine='vector' runs the host engine, which the device
        scan is held against."""
        _check_engine(engine)
        pipeline = Pipeline()
        ctx = self._scan_init(query.qc_after, query.qc_before, pipeline)
        if isinstance(ctx, DNError):
            raise ctx
        files, fmt = ctx
        _require_native()
        # parse stages first: --counters lists stages in creation order
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        scanner = self._make_scan(query, pipeline, self.ds_filter, device,
                                  engine)
        self._scan_native(scanner, files, fmt, stages)
        scanner.finish()
        return ScanResult(pipeline, scanner.aggr.points())

    def _make_scan(self, query, pipeline, ds_filter, device, engine):
        if engine == 'device':
            from .device_scan import DeviceScan
            return DeviceScan(query, self.ds_timefield, pipeline,
                              ds_filter=ds_filter, device=device)
        return VectorScan(query, self.ds_timefield, pipeline,
                          ds_filter=ds_filter)

    def _scan_native(self, scanner, files, fmt, stages):
        """Scan via the C++ columnar parser: one pass over the
        concatenated bytes, projected fields only, batched into the
        engine."""
        parser_stage, adapter_stage = stages

        skinner = fmt == 'json-skinner'
        parser, src = _native_parser(scanner.projection(), skinner)

        def flush():
            n = parser.batch_size()
            if n == 0:
                return
            nlines, nbad = parser.counters()
            _bump_parse_counters(parser_stage, adapter_stage,
                                 nlines, nbad, n)
            weights = _batch_weights(skinner, parser, n)
            scanner.write_native_batch(src, weights)
            parser.reset_batch()

        self._stream_native(files, parser, flush, BATCH_SIZE)
        # counters even when the final batch was empty
        nlines, nbad = parser.counters()
        if nlines:
            parser_stage.counters['ninputs'] = nlines
            parser_stage.counters['noutputs'] = nlines - nbad
            if nbad:
                parser_stage.counters['invalid json'] = nbad

    # -- build / index-scan -----------------------------------------------

    def check_time_args(self, time_after, time_before):
        if time_after is not None and time_before is None:
            return DNError('cannot specify --after without --before')
        if time_before is not None and time_after is None:
            return DNError('cannot specify --before without --after')
        return None

    def check_index_args(self, interval, needsindex, needstime):
        if needsindex and self.ds_indexpath is None:
            return DNError('datasource is missing "indexpath"')
        if needstime and interval != 'all' and self.ds_timefield is None:
            return DNError('datasource is missing "timefield"')
        return None

    def build(self, metrics, interval, time_after=None, time_before=None,
              dry_run=False, device=None, engine='device'):
        """Build the datasource's index tree for `metrics`: one pass
        over raw data, each metric's aggregate written to
        interval-chunked shards through the crash-safe journal.
        `device`/`engine` as for scan()."""
        from . import resources as mod_resources
        # a full disk / exhausted fd table mid-build surfaces as the
        # clean retryable disk_full DNError, never a traceback — the
        # two-phase journal already leaves the tree pre-build or
        # post-build, never torn
        with mod_resources.translate_pressure_errors('index build'):
            return self._index_scan_impl(
                metrics, interval, self.ds_filter, time_after,
                time_before, dry_run, 'index', device, engine)

    def index_scan(self, metrics, interval, filter=None, time_after=None,
                   time_before=None, device=None, engine='device'):
        """The build's scan with tagged points (each carrying
        __dn_metric) as the result instead of index files."""
        return self._index_scan_impl(
            metrics, interval, filter, time_after, time_before, False,
            'points', device, engine)

    def _index_scan_impl(self, metrics, interval, filter, time_after,
                         time_before, dry_run, sink, device, engine):
        """One pass over raw data feeding every metric's scan; output goes
        to index files (build) or tagged points (index-scan).
        (reference: lib/datasource-file.js:322-433)"""
        _check_engine(engine)
        pipeline = Pipeline()
        error = self.check_time_args(time_after, time_before)
        if error is None:
            error = self.check_index_args(interval, sink == 'index', True)
        if error is not None:
            raise error

        ctx = self._scan_init(time_after, time_before, pipeline)
        if isinstance(ctx, DNError):
            raise ctx
        files, fmt = ctx

        if dry_run:
            return ScanResult(pipeline,
                              dry_run_files=[p for p, st in files])

        queries = [mod_query.metric_query(m, time_after, time_before,
                                          interval, self.ds_timefield)
                   for m in metrics]
        _require_native()
        scanners = self._index_scan_native(queries, files, fmt, filter,
                                           pipeline, device, engine)

        if sink == 'index':
            # columnar hand-off: each metric's aggregate goes to the
            # index writer as parallel key columns + weights
            from . import index_build_mt as mod_ibmt
            blocks = []
            for s in scanners:
                s.finish()
                cols, weights = s.aggr.point_rows()
                blocks.append((list(s.aggr.decomps), cols, weights))
            mod_ibmt.write_index_blocks(metrics, interval,
                                        self.ds_indexpath, blocks)
            return ScanResult(pipeline)

        tagged = []
        for qi, s in enumerate(scanners):
            s.finish()
            for fields, value in s.aggr.points():
                fields['__dn_metric'] = qi
                tagged.append((fields, value))
        return ScanResult(pipeline, points=tagged)

    def _index_scan_native(self, queries, files, fmt, filter, pipeline,
                           device, engine):
        """Build fan-out over the native parser: ONE pass over raw bytes
        feeds every metric's scan (the reference pipes one parse stream
        into N StreamScans, lib/datasource-file.js:403-427).  On the
        device the metrics fold through one DeviceScanStack per batch;
        DN_STACK=0 keeps the per-scan device folds."""
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        parser_stage, adapter_stage = stages

        # the datasource filter is evaluated once on the shared parse
        # stream; each metric's own filter lives in its scan
        ds_pred = ds_stage = holder = None
        if filter is not None:
            holder = _Holder()
            ds_pred = VectorPredicate(filter, holder)
            ds_stage = pipeline.stage('Datasource filter')
        scanners = []
        for q in queries:
            scanners.append(self._make_scan(q, pipeline, None, device,
                                            engine))
            pipeline.stage('Add __dn_metric')

        skinner = fmt == 'json-skinner'
        proj = {}
        if holder is not None:
            for f in holder.filter_fields:
                proj.setdefault(f, [False, True])
        for s in scanners:
            for p, h, d in s.projection():
                ent = proj.setdefault(p, [False, False])
                ent[0] = ent[0] or h
                ent[1] = ent[1] or d
        parser, src = _native_parser(
            [(p, h, d) for p, (h, d) in proj.items()], skinner)

        stack = None
        if engine == 'device':
            from .device_scan import make_stack
            stack = make_stack(scanners)

        def flush():
            n = parser.batch_size()
            if n == 0:
                return
            nlines, nbad = parser.counters()
            _bump_parse_counters(parser_stage, adapter_stage,
                                 nlines, nbad, n)
            provider = NativeColumns(src)
            weights = _batch_weights(skinner, parser, n)
            alive0 = None
            if ds_pred is not None:
                alive0 = _eval_ds_filter(ds_pred, ds_stage, provider, n)
            if stack is not None:
                stack.process(provider, weights, alive0)
            else:
                for s in scanners:
                    s._process(provider, weights, alive=alive0)
            parser.reset_batch()

        self._stream_native(files, parser, flush, BATCH_SIZE)
        nlines, nbad = parser.counters()
        if nlines:
            parser_stage.counters['ninputs'] = nlines
            parser_stage.counters['noutputs'] = nlines - nbad
            if nbad:
                parser_stage.counters['invalid json'] = nbad
        return scanners

    def _index_write(self, metrics, interval, tagged_points):
        """Write tagged aggregated points (index_scan's result) into
        interval-chunked index files via the bulk write path; the shard
        set publishes through the crash-safe journal.  (reference:
        lib/datasource-file.js:444-547)"""
        from . import index_build_mt as mod_ibmt
        writer = mod_ibmt.StreamingIndexWriter(metrics, interval,
                                               self.ds_indexpath)
        try:
            writer.write_points(tagged_points)
            writer.finish()
        except BaseException:
            writer.abort()
            raise

    # -- query ------------------------------------------------------------

    def index_find_params(self, interval, time_after, time_before):
        """(reference: lib/dragnet-impl.js:194-236)"""
        if interval == 'day':
            return (os.path.join(self.ds_indexpath, 'by_day'),
                    '%Y-%m-%d.sqlite', time_after, time_before)
        if interval == 'hour':
            return (os.path.join(self.ds_indexpath, 'by_hour'),
                    '%Y-%m-%d-%H.sqlite', time_after, time_before)
        if interval == 'all':
            return (os.path.join(self.ds_indexpath, 'all'), None, None,
                    None)
        return DNError('unsupported interval: "%s"' % interval)

    def _cached_index_walk(self, root, pipeline):
        """The unbounded index-tree walk, memoized on the directory's
        stat identity (index_query_mt.cached_find_walk)."""
        from . import index_query_mt as mod_iqmt
        return mod_iqmt.cached_find_walk(root, pipeline)

    def index_query_paths(self, query, interval, pipeline):
        """Enumerate the shard files an index query over `query` x
        `interval` would read: argument checks, the crash-recovery
        sweep, the (possibly memoized) tree walk, and the
        journal/tmp/quarantine litter filter — everything up to (not
        including) time-range pruning.  Returns (root, timeformat,
        files) with files as (path, statbuf) pairs in find order."""
        error = self.check_time_args(query.qc_after, query.qc_before)
        if error is None:
            error = self.check_index_args(interval, True, False)
        if error is not None:
            raise error

        params = self.index_find_params(interval or 'all', query.qc_after,
                                        query.qc_before)
        if isinstance(params, DNError):
            raise params
        root, timeformat, after, before = params

        # crash-recovery sweep (TTL-throttled): a builder that died
        # mid-publish must be rolled forward/back before this reader
        # walks the tree (index_journal)
        from . import index_journal as mod_journal
        mod_journal.maybe_sweep(self.ds_indexpath)

        if before is None and pipeline.warn_func is None:
            # unbounded query over a flat index tree: the whole-tree
            # walk (one stat per shard) is memoized on the directory's
            # stat identity — stage counters replay byte-identically
            files = self._cached_index_walk(root, pipeline)
        else:
            files = self._find(root, timeformat, after, before, pipeline)
        if isinstance(files, DNError):
            raise files
        # never open build machinery as a shard: journals, in-flight
        # tmps (a concurrent builder's), and the quarantine directory
        # stay out of the shard set
        files = [(p, st) for p, st in files
                 if not mod_journal.is_index_litter(p)]
        if timeformat is not None:
            # follow --append mini-generations: bounded finds
            # enumerate exact in-window filenames and can never name
            # a `<shard>.sqlite-gNNNNNN`; splice existing generations
            # in after their bases (unbounded walks see them
            # naturally)
            from . import rollup as mod_rollup
            files = mod_rollup.augment_generation_files(root, files)
        return root, timeformat, files

    def query(self, query, interval, dry_run=False, device=None,
              engine='device'):
        """Query the indexes.  engine='device' aggregates the stacked
        path's weight sums on `device` (CUDA unless the caller asks for
        the CPU; DN_INDEX_DEVICE=0 pins the host bincount);
        engine='vector' keeps them on the host.  (reference:
        lib/datasource-file.js:573-691)"""
        from . import device_index as mod_di
        _check_engine(engine)
        pipeline = Pipeline()
        root, timeformat, files = self.index_query_paths(
            query, interval, pipeline)

        if dry_run:
            return ScanResult(pipeline,
                              dry_run_files=[p for p, st in files])
        if engine == 'device':
            from .ops import resolve_device
            device = resolve_device(device)

        index_list = pipeline.stage('Index List')
        aggr = Aggregator(query,
                          stage=pipeline.stage('Index Result Aggregator'))

        # Shard fan-out (index_query_mt): time-range pruning by shard
        # filename, then a DN_IQ_THREADS worker pool over the shard
        # handle cache, merged in find order — byte-identical to the
        # sequential loop
        from . import index_query_mt as mod_iqmt
        paths = [p for p, st in files]
        paths, npruned = mod_iqmt.prune_shards(
            paths, timeformat, query.qc_after, query.qc_before)
        # time-bounded finds never enumerate out-of-window shards, so
        # count the tree's skipped files for the pruned counter (the
        # found list can only re-prune what enumeration missed)
        npruned = max(npruned, mod_iqmt.count_pruned_shards(
            root, timeformat, query.qc_after, query.qc_before))
        if npruned:
            index_list.bump_hidden('index shards pruned', npruned)
        index_list.bump_hidden('index shards queried', len(paths))

        # verified reads (integrity.py): a catalogued shard that is
        # MISSING from the walk (quarantined after a corrupt detect,
        # or externally deleted) must degrade explicitly — a clean
        # retryable error naming the shard — never silently short
        # result bytes
        from . import integrity as mod_integrity
        if mod_integrity.verify_mode() != 'off':
            mod_integrity.check_missing(
                self.ds_indexpath, paths,
                subdir=os.path.basename(root)
                if timeformat is not None else None,
                timeformat=timeformat, after_ms=query.qc_after,
                before_ms=query.qc_before)

        nworkers = mod_iqmt.iq_threads()
        LOG.debug('query start', indexroot=root, nindexes=len(paths),
                  npruned=npruned, nworkers=nworkers,
                  interval=interval)

        aggr_stage = aggr.stage

        def merge(items):
            # per-shard aggregates arrive as key items (the
            # Aggregator wire format) in emission order: write_key
            # replays them byte-identically to re-writing the
            # shard's points.  Counter parity with the per-point
            # write() loop: one Index List input/output and one
            # aggregator-stage input per point, bumped in bulk.
            npts = len(items)
            if npts == 0:
                return
            index_list.bump('ninputs', npts)
            index_list.bump('noutputs', npts)
            aggr_stage.bump('ninputs', npts)
            aggr.merge_key_items(items)

        # Query planner (rollup.py): serve from the coarsest covering
        # rollup shards and fold follow mini-generations into their
        # logical base shard.  plan_query returns None whenever the
        # walk is plain per-file shards — the stacked/pooled paths
        # below then run completely untouched.
        from . import rollup as mod_rollup
        plan = mod_rollup.plan_query(self.ds_indexpath,
                                     interval or 'all', paths, query)
        if plan is not None:
            index_list.bump_hidden('index shards via rollup',
                                   plan['ncovered'])
            index_list.bump_hidden('rollup shards queried',
                                   plan['nrollup'])

            def query_one(path, q):
                if nworkers <= 0:
                    return mod_iqmt.query_shard_once(path, q)
                return mod_iqmt._query_shard_cached(path, q)

            mod_rollup.execute_plan(plan, query, query_one, merge)
            mod_di.note_route('rollup plan')
            return ScanResult(pipeline, points=aggr.points())

        # Stacked cross-shard execution (index_query_stack, default):
        # shard readers only LOAD matching column blocks, and one
        # vectorized filter+group-by over the concatenated batch
        # replaces the per-shard mask -> groupby -> merge loop, its
        # weight sums on the device lane.  Falls back to the
        # per-shard loop when the query shape or the exactness gate
        # (non-integer weights) demands it, or under DN_IQ_STACK=0.
        from . import index_query_stack as mod_iqs
        if not mod_iqs.stack_enabled():
            route = 'per-shard: DN_IQ_STACK=0'
        elif not mod_iqs.stack_eligible(query):
            route = 'per-shard: breakdown not stack-eligible'
        elif mod_iqs.run_stacked(paths, query, aggr, index_list,
                                 engine=engine, device=device):
            route = None
        else:
            route = 'per-shard: weights past the exactness gate'
        if route is not None:
            mod_iqmt.run_shard_queries(paths, query, nworkers, merge)
            mod_di.note_route(route)

        return ScanResult(pipeline, points=aggr.points())

    def _stream_native(self, files, parser, flush, batch_size):
        """Feed the concatenated file bytes to the native parser,
        flushing a batch whenever enough records accumulate (partial
        trailing lines join across file boundaries — catstreams
        semantics).  The bulk of each read chunk is parsed in place
        (zero-copy span); only the carry-spanning line is stitched."""
        # larger reads amortize the multithreaded parse's fork/join; the
        # cap bounds how far a batch can overshoot the flush threshold
        # (flush is only checked between reads).  DN_READ_SIZE overrides
        # (testing / IO tuning).
        readsz = min(1 << 24, (1 << 22) * getattr(parser, 'nthreads', 1))
        try:
            readsz = int(os.environ.get('DN_READ_SIZE', 0)) or readsz
        except ValueError:
            pass
        carry = b''
        for chunk in _read_ahead(files, readsz):
            nl = chunk.rfind(b'\n')
            if nl == -1:
                carry += chunk
                continue
            start = 0
            if carry:
                first = chunk.index(b'\n', 0, nl + 1)
                parser.parse(carry + chunk[:first + 1])
                start = first + 1
            arr = np.frombuffer(chunk, dtype=np.uint8)
            if nl + 1 > start:
                parser.parse_at(arr[start:].ctypes.data, nl + 1 - start)
            carry = chunk[nl + 1:]
            if parser.batch_size() >= batch_size:
                flush()
        if carry:
            parser.parse(carry)
        flush()


def _native_parser(proj, skinner):
    """(parser, provider source) for a projection [(path, date_hint,
    need_dict)]: json-skinner reads `fields.<path>` plus `value`, and
    the source presents those under the unprefixed names.  One source
    per pass, so per-column caches persist across batches."""
    if skinner:
        paths = ['fields.' + p for p, h, d in proj] + ['value']
        hints = [h for p, h, d in proj] + [False]
        dicts = [d for p, h, d in proj] + [True]
    else:
        paths = [p for p, h, d in proj]
        hints = [h for p, h, d in proj]
        dicts = [d for p, h, d in proj]
    parser = mod_native.NativeParser(paths, hints, dicts)
    if not skinner:
        return parser, parser
    remap = {p: np_ for (p, h, d), np_ in zip(proj, paths)}
    return parser, _RemappedParser(parser, remap)


def _check_engine(engine):
    if engine not in ENGINES:
        raise DNError('unknown scan engine "%s"' % engine)


def _require_native():
    if mod_native.get_lib() is None:
        raise DNError('native parser (native/dnparse.cc) unavailable: '
                      'build it with "make -C native"')


class _Holder(object):
    """The datasource predicate's field registry (VectorPredicate
    records the fields its leaves read here)."""

    def __init__(self):
        self.filter_fields = []


def _eval_ds_filter(pred, stage, provider, n):
    """The datasource filter over one batch: stage counters and the
    alive mask every metric's scan starts from."""
    stage.bump('ninputs', n)
    out = pred.outcomes(provider)
    nfail = int((out == 2).sum())
    ndrop = int((out == 0).sum())
    if nfail:
        stage.bump('nfailedeval', nfail)
    if ndrop:
        stage.bump('nfilteredout', ndrop)
    alive0 = out == TRUE
    stage.bump('noutputs', int(alive0.sum()))
    return alive0


def _read_ahead(files, readsz):
    """Yield the concatenated chunk stream of `files` with a producer
    thread reading one chunk ahead (so file IO overlaps parse and
    engine work while at most ~2 chunks are resident).  Producer
    exceptions (unreadable file mid-stream) re-raise at the
    consumer."""
    import queue as mod_queue
    import threading

    q = mod_queue.Queue(maxsize=1)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except mod_queue.Full:
                continue
        return False

    def produce():
        try:
            for path, st in files:
                for chunk in mod_ingest.open_byte_source(path, readsz):
                    if not put(chunk):
                        return
            put(None)
        except BaseException as e:     # re-raised by the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _bump_parse_counters(parser_stage, adapter_stage, nlines, nbad, n):
    """Parse-layer counters (totals are monotonic; assigned, not
    accumulated) plus the per-batch adapter bumps."""
    parser_stage.counters['ninputs'] = nlines
    parser_stage.counters['noutputs'] = nlines - nbad
    if nbad:
        parser_stage.counters['invalid json'] = nbad
    if adapter_stage is not None and n:
        adapter_stage.bump('ninputs', n)
        adapter_stage.bump('noutputs', n)


def _batch_weights(skinner, src, n):
    """Per-record weights for one batch: 1 for raw json, the coerced
    point value for json-skinner."""
    if skinner:
        tags, nums, strcodes = src.columns('value')
        return _skinner_weights(tags, nums, strcodes, src)
    return np.ones(n, dtype=np.float64)


def _skinner_weights(tags, nums, strcodes, parser):
    """json-skinner point weights with JS Number coercion (NaN -> 0)."""
    from . import jsvalues as jsv
    weights = np.zeros(len(tags), dtype=np.float64)
    m = (tags == mod_native.TAG_INT) | (tags == mod_native.TAG_NUMBER)
    weights[m] = nums[m]
    weights[tags == mod_native.TAG_TRUE] = 1.0
    ms = tags == mod_native.TAG_STRING
    if ms.any():
        d = parser.dictionary('value')
        table = np.array(
            [0.0 if (f := jsv.to_number(s)) != f else f for s in d],
            dtype=np.float64)
        weights[ms] = table[strcodes[ms]]
    return weights


class _RemappedParser(object):
    """Presents a NativeParser whose projection paths were prefixed
    (json-skinner: fields.*) under the engine's unprefixed names."""

    def __init__(self, parser, remap):
        self.parser = parser
        self.remap = remap
        # alias the wrapped parser's decoded-array cache (if it has
        # one) so the engine's per-provider cache is not defeated
        cache = getattr(parser, '_array_cache', None)
        if cache is not None:
            self._array_cache = cache

    def batch_size(self):
        return self.parser.batch_size()

    def columns(self, path):
        return self.parser.columns(self.remap[path])

    def date_columns(self, path):
        return self.parser.date_columns(self.remap[path])

    def dictionary(self, path):
        return self.parser.dictionary(self.remap[path])

    def field_stats(self, path):
        return self.parser.field_stats(self.remap[path])

    def nums_i32(self, path):
        return self.parser.nums_i32(self.remap[path])

    def date_stats(self, path):
        return self.parser.date_stats(self.remap[path])

    def date_i32(self, path):
        return self.parser.date_i32(self.remap[path])

    def date_err(self, path):
        return self.parser.date_err(self.remap[path])

    def tags_col(self, path):
        return self.parser.tags_col(self.remap[path])

    def strcodes_col(self, path):
        return self.parser.strcodes_col(self.remap[path])
