"""File-backend scan, build, index-scan, index-read and query: input
enumeration, the parse lanes, the scan engines and the index walk.

Counterpart of dragnet_tpu/datasource_file.py (`scan`, `build`,
`index_scan`, `index_read`, `query`): input enumeration (strftime-pruned
when the datasource has a time format), one pass over the concatenated
file bytes (a partial trailing line joins across file boundaries)
through the parse lane DN_PARSE picks (byteparse.choose_lane: the C++
parser, native/dnparse.cc; the byte lane, byteparse.ByteParser, with its
quote-parity scan in numpy or on the device; or the Python record path),
batches fed to the forced device scan (engine='device'), to the host
engine (engine.VectorScan) on DN_SCAN_THREADS workers (scan_mt.py), or
under engine='auto' to those workers until the device takes the stream
over (_takeover_stream, device_scan.AutoDeviceScan). engine='host'
(DN_ENGINE=host), DN_BUILD_ENGINE=host and a warning callback
(`--warnings`) run the per-record engine (scan.StreamScan). A build
feeds ONE parse stream to every metric's scan (stacked on the device:
DeviceScanStack) and hands each metric's aggregate to the index writer
(index_build_mt.py). A query walks the index tree and answers through
the rollup planner, the stacked path (index_query_stack.py, its weight
sums on the device: device_index.py) or the per-shard loop
(index_query_mt.py), in the reference's order.
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
from . import byteparse as mod_byteparse
from .engine import (BATCH_SIZE, NativeColumns, VectorPredicate, VectorScan,
                     weights_array)
from .ops.kernels import TRUE
from .scan import FilterStage, StreamScan
from .vpipe import Pipeline

ENGINES = ('device', 'auto', 'vector', 'host')

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
        self.parse_plan = None      # scan dry run: DN_PARSE lane info
        self.dry_run_plan = None    # cluster backend: execution plan

    def clone_for_output(self):
        """An output-formatting view of this result with a PRIVATE
        pipeline (stage names/counters copied, points shared
        read-only).  The CLI output layer mutates the pipeline it
        formats — it appends a Flattener stage and bumps counters — so
        `dn serve` requests coalesced onto one shared execution (or
        answered from the result cache) each format through their own
        clone."""
        pl = Pipeline()
        pl.warn_func = None
        for s in self.pipeline.stages:
            stage = pl.stage(s.name)
            stage.counters = dict(s.counters)
            stage.hidden = set(s.hidden)
        rv = ScanResult(pl, points=self.points,
                        dry_run_files=self.dry_run_files)
        rv.parse_plan = self.parse_plan
        rv.dry_run_plan = self.dry_run_plan
        return rv


class DatasourceFile(object):
    def __init__(self, dsconfig):
        bc = dsconfig['ds_backend_config']
        # the route of the last scan or build (_route_doc)
        self.last_route = None
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

    def scan(self, query, device=None, engine='device', dry_run=False,
             warn_func=None):
        """Scan raw data to execute a query.  Returns a ScanResult whose
        points are the aggregated output.  engine='device' (the CLI's
        DN_ENGINE=jax) runs the device scan on `device` (CUDA unless the
        caller asks for the CPU); engine='auto' runs the multithreaded
        host engine with the device's mid-stream takeover
        (device_scan.AutoDeviceScan; the host engine alone when the
        caller asked for the CPU); engine='vector' runs the host engine,
        which the device scan is held against; engine='host' runs the
        per-record engine (scan.StreamScan), as does a `warn_func`
        (ordered per-record warnings).  The other engines parse through
        the lane DN_PARSE picks; its device lane runs on `device`.  A
        dry run lists the files and the lane (`parse_plan`)."""
        _check_engine(engine)
        pipeline = Pipeline()
        pipeline.warn_func = warn_func
        ctx = self._scan_init(query.qc_after, query.qc_before, pipeline)
        if isinstance(ctx, DNError):
            raise ctx
        files, fmt = ctx

        if dry_run:
            result = ScanResult(pipeline,
                                dry_run_files=[p for p, st in files])
            lane = self._choose_lane([query], self.ds_filter, fmt, True)
            result.parse_plan = {'parse_lane': lane.lane,
                                 'parse_mode': mod_byteparse.parse_mode(),
                                 'reason': lane.reason}
            return result

        lane = self._choose_lane([query], self.ds_filter, fmt,
                                 warn_func is None and engine != 'host')
        if lane is None:
            scanner = self._scan_records(query, files, fmt, pipeline)
        elif lane.engaged or mod_native.get_lib() is not None:
            scanner = self._scan_native(query, files, fmt, pipeline,
                                        device, engine, lane)
        else:
            scanner = self._scan_batches(query, files, fmt, pipeline,
                                         device, engine, lane)
        if hasattr(scanner, 'finish'):
            scanner.finish()
        self.last_route = _route_doc([scanner])
        return ScanResult(pipeline, scanner.aggr.points())

    def _choose_lane(self, queries, ds_filter, fmt, vector):
        """The parse lane of a scan or build (byteparse.choose_lane), or
        None for the per-record engine (`vector` False)."""
        if not vector:
            return None
        return mod_byteparse.choose_lane(
            queries, self.ds_timefield, ds_filter, fmt,
            mod_native.get_lib() is not None)

    def _scan_records(self, query, files, fmt, pipeline):
        """The per-record engine: every record through scan.StreamScan,
        in order (warnings print as they happen)."""
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        scanner = StreamScan(query, self.ds_timefield, pipeline,
                             ds_filter=self.ds_filter)
        records = mod_ingest.iter_records(
            mod_ingest.iter_lines([p for p, st in files]), fmt,
            stages=stages)
        for fields, value in records:
            scanner.write(fields, _record_weight(value))
        return scanner

    def _scan_batches(self, query, files, fmt, pipeline, device, engine,
                      lane):
        """The vectorized engine over the Python record path (no
        columnar parser: the native library is absent and the byte lane
        could not engage): batches of parsed records through
        VectorScan.write_batch (engine.DictColumns)."""
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        # the ineligibility counter must still appear
        mod_byteparse.note_ineligible(stages[0], lane)
        scanner = self._make_scan(self._scan_cls(engine, device), query,
                                  pipeline, self.ds_filter, device)
        records = mod_ingest.iter_records(
            mod_ingest.iter_lines([p for p, st in files]), fmt,
            stages=stages)
        buf_r, buf_w = [], []
        for fields, value in records:
            buf_r.append(fields)
            buf_w.append(value)
            if len(buf_r) >= BATCH_SIZE:
                scanner.write_batch(buf_r, buf_w)
                buf_r, buf_w = [], []
        scanner.write_batch(buf_r, buf_w)
        return scanner

    def _scan_cls(self, engine, device):
        """The scan class for `engine` on `device`
        (device_scan.scan_class); tests pin it to a subclass, and the
        cluster backend to its mesh scan."""
        from .device_scan import scan_class
        return scan_class(engine, device)

    def _make_scan(self, cls, query, pipeline, ds_filter, device):
        if cls is VectorScan:
            return VectorScan(query, self.ds_timefield, pipeline,
                              ds_filter=ds_filter)
        return cls(query, self.ds_timefield, pipeline,
                   ds_filter=ds_filter, device=device)

    def _scan_native(self, query, files, fmt, pipeline, device, engine,
                     lane):
        """Scan via a columnar parser — the C++ one, or the byte lane
        (DN_PARSE=vector|device): one pass over the concatenated bytes,
        projected fields only, batched into the engine.  With
        DN_SCAN_THREADS > 0 the host engine step runs on worker threads
        pipelined behind the parse (scan_mt), with byte-identical
        results; under auto the device may take the stream over from
        them (_takeover_stream)."""
        from . import scan_mt
        # parse stages first: --counters lists stages in creation order
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        parser_stage, adapter_stage = stages
        stage_offset = len(pipeline.stages)
        scan_cls = self._scan_cls(engine, device)
        scanner = self._make_scan(scan_cls, query, pipeline,
                                  self.ds_filter, device)

        skinner = fmt == 'json-skinner'
        proj = scanner.projection()
        parser, src = _make_parser(lane, proj, skinner, parser_stage,
                                   device)
        paths, hints, dicts = parser.projection
        remap = src.remap if skinner else None

        nworkers = scan_mt.scan_threads()
        use_mt = nworkers > 0 and scan_cls is VectorScan
        # auto runs the MT host engine too: workers are plain
        # VectorScans, and the device path (the main scanner) can TAKE
        # OVER the stream once its background probe succeeds and it
        # wins its audition — or hand back if it loses probation
        auto_mt = nworkers > 0 and getattr(scan_cls, 'AUTO_STREAM', False)
        progress_fn = getattr(scanner, 'set_progress', None)

        if use_mt or auto_mt:
            def build_worker(wp):
                wscan = VectorScan(query, self.ds_timefield, wp,
                                   ds_filter=self.ds_filter)
                # workers drain per batch through the recorder; the
                # deferred columnar merge would hold rows past drain
                wscan._defer_enabled = False
                rec = scan_mt.BatchRecorder(wscan.aggr.stage)
                wscan.aggr = rec

                def process(snap):
                    wsrc = _RemappedParser(snap, remap) if skinner \
                        else snap
                    wscan._process(NativeColumns(wsrc),
                                   _batch_weights(skinner, snap,
                                                  snap.batch_size()))
                    return rec.drain()
                return process

            def new_executor():
                # one radix merge per executor epoch: finalize() runs
                # inside finish(), so a device takeover (or the final
                # drain) always observes this executor's batches fully
                # merged, in order
                radix = scan_mt.RadixMerge(scanner)
                return scan_mt.MTScanExecutor(nworkers, build_worker,
                                              radix.apply_calls,
                                              pipeline, stage_offset,
                                              finish_fn=radix.finalize)

            def device_batch(dsrc, n):
                nlines, nbad = parser.counters()
                _bump_parse_counters(parser_stage, adapter_stage,
                                     nlines, nbad, n)
                weights = _batch_weights(skinner, parser, n)
                scanner.write_native_batch(dsrc, weights)
                parser.reset_batch()
                if scanner._disabled:
                    scanner._flush()
                    return False     # hand back to the MT executor
                return True

            def submit_batch(ex, n):
                snap = scan_mt.ParserSnapshot(parser, paths, hints, dicts)
                parser.reset_batch()
                _bump_parse_counters(parser_stage, adapter_stage,
                                     snap.nlines, snap.nbad, n)
                if auto_mt:
                    scanner.note_external_batch(n)
                    scanner.shadow_feed(snap, n)
                ex.submit(snap)

            if auto_mt:
                from .device_scan import DeviceScan
                scanner.enable_shadow(
                    lambda: [DeviceScan(query, self.ds_timefield,
                                        Pipeline(),
                                        ds_filter=self.ds_filter,
                                        device=scanner.device)],
                    lambda snap: NativeColumns(
                        _RemappedParser(snap, remap) if skinner
                        else snap),
                    lambda snap, n: _batch_weights(skinner, snap, n))

            self._takeover_stream(
                files, parser, BATCH_SIZE, progress_fn, new_executor,
                submit_batch,
                scanner.take_over_now if auto_mt else None,
                lambda: src, device_batch)
        else:
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

            self._stream_native(files, parser, flush, BATCH_SIZE,
                                progress=progress_fn)
        # counters even when the final batch was empty
        nlines, nbad = parser.counters()
        if nlines:
            parser_stage.counters['ninputs'] = nlines
            parser_stage.counters['noutputs'] = nlines - nbad
            if nbad:
                parser_stage.counters['invalid json'] = nbad
        mod_byteparse.publish_counters(parser_stage, parser)
        return scanner

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
              dry_run=False, device=None, engine='device', warn_func=None):
        """Build the datasource's index tree for `metrics`: one pass
        over raw data, each metric's aggregate written to
        interval-chunked shards through the crash-safe journal.
        `device`/`engine`/`warn_func` as for scan(); DN_BUILD_ENGINE=host
        also runs the per-record engine."""
        from . import resources as mod_resources
        # a full disk / exhausted fd table mid-build surfaces as the
        # clean retryable disk_full DNError, never a traceback — the
        # two-phase journal already leaves the tree pre-build or
        # post-build, never torn
        with mod_resources.translate_pressure_errors('index build'):
            return self._index_scan_impl(
                metrics, interval, self.ds_filter, time_after,
                time_before, dry_run, 'index', device, engine, warn_func)

    def index_scan(self, metrics, interval, filter=None, time_after=None,
                   time_before=None, device=None, engine='device',
                   warn_func=None):
        """The build's scan with tagged points (each carrying
        __dn_metric) as the result instead of index files."""
        return self._index_scan_impl(
            metrics, interval, filter, time_after, time_before, False,
            'points', device, engine, warn_func)

    def _index_scan_impl(self, metrics, interval, filter, time_after,
                         time_before, dry_run, sink, device, engine,
                         warn_func=None):
        """One pass over raw data feeding every metric's scan; output goes
        to index files (build) or tagged points (index-scan).
        (reference: lib/datasource-file.js:322-433)"""
        _check_engine(engine)
        pipeline = Pipeline()
        pipeline.warn_func = warn_func
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
        # --warnings needs the per-record engine for ordered warning
        # output (same rule as scan())
        lane = self._choose_lane(
            queries, filter, fmt,
            warn_func is None and engine != 'host' and
            os.environ.get('DN_BUILD_ENGINE', 'auto') != 'host')
        if lane is not None and (lane.engaged or
                                 mod_native.get_lib() is not None):
            scanners = self._index_scan_native(queries, files, fmt,
                                               filter, pipeline, device,
                                               engine, lane)
        else:
            scanners = self._index_scan_records(queries, files, fmt,
                                                filter, pipeline, lane)

        if sink == 'index':
            # columnar hand-off: each metric's aggregate goes to the
            # index writer as parallel key columns + weights
            from . import index_build_mt as mod_ibmt
            blocks = []
            for s in scanners:
                if hasattr(s, 'finish'):
                    s.finish()
                cols, weights = s.aggr.point_rows()
                blocks.append((list(s.aggr.decomps), cols, weights))
            self.last_route = _route_doc(scanners)
            mod_ibmt.write_index_blocks(metrics, interval,
                                        self.ds_indexpath, blocks)
            return ScanResult(pipeline)

        tagged = []
        for qi, s in enumerate(scanners):
            if hasattr(s, 'finish'):
                s.finish()
            for fields, value in s.aggr.points():
                fields['__dn_metric'] = qi
                tagged.append((fields, value))
        self.last_route = _route_doc(scanners)
        return ScanResult(pipeline, points=tagged)

    def _index_scan_records(self, queries, files, fmt, filter, pipeline,
                            lane):
        """Build fan-out over the per-record engine: one StreamScan per
        metric, fed every record the datasource filter keeps.  The
        filter runs once on the shared parse stream; each metric's own
        filter lives in its StreamScan (reference:
        lib/datasource-file.js:124-192 vs :403-427)."""
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        if lane is not None:
            # no native library AND the byte lane could not engage:
            # the ineligibility counter must still appear
            mod_byteparse.note_ineligible(stages[0], lane)
        ds_filter_stage = None
        if filter is not None:
            from . import krill as mod_krill
            ds_filter_stage = FilterStage(
                mod_krill.create(filter),
                pipeline.stage('Datasource filter'))
        scanners = []
        for q in queries:
            scanners.append(StreamScan(q, self.ds_timefield, pipeline,
                                       ds_filter=None))
            pipeline.stage('Add __dn_metric')
        lines = mod_ingest.iter_lines([p for p, st in files])
        for fields, value in mod_ingest.iter_records(lines, fmt,
                                                     stages=stages):
            if ds_filter_stage is not None and \
                    not ds_filter_stage.accept(fields):
                continue
            for s in scanners:
                s.write(fields, value)
        return scanners

    def _index_scan_native(self, queries, files, fmt, filter, pipeline,
                           device, engine, lane):
        """Build fan-out over a columnar parser (the C++ one or the
        byte lane): ONE pass over raw bytes feeds every metric's scan
        (the reference pipes one parse stream into N StreamScans,
        lib/datasource-file.js:403-427).  On the device the metrics fold
        through one DeviceScanStack per batch (DN_STACK=0 keeps the
        per-scan device folds); the host engine runs on DN_SCAN_THREADS
        workers, and under auto the device takes the stream over for all
        metrics together."""
        from . import scan_mt
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        parser_stage, adapter_stage = stages
        stage_offset = len(pipeline.stages)
        scan_cls = self._scan_cls(engine, device)

        def make_scan_set(pl, cls):
            """The datasource predicate (+ its stage) and one scan per
            metric, with the same stage layout on the main and every
            worker pipeline.  The datasource filter is evaluated once on
            the shared parse stream; each metric's own filter lives in
            its scan."""
            pred = stage = holder = None
            if filter is not None:
                holder = _Holder()
                pred = VectorPredicate(filter, holder)
                stage = pl.stage('Datasource filter')
            scans = []
            for q in queries:
                scans.append(self._make_scan(cls, q, pl, None, device))
                pl.stage('Add __dn_metric')
            return pred, stage, scans, holder

        ds_pred, ds_stage, scanners, holder = make_scan_set(pipeline,
                                                            scan_cls)

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
        parser, src = _make_parser(
            lane, [(p, h, d) for p, (h, d) in proj.items()], skinner,
            parser_stage, device)
        paths, hints, dicts = parser.projection
        remap = src.remap if skinner else None

        stack = None
        if scan_cls is not VectorScan:
            from .device_scan import make_stack
            stack = make_stack(scanners)

        nworkers = scan_mt.scan_threads()
        use_mt = nworkers > 0 and scan_cls is VectorScan
        # auto builds mirror the scan path: MT host workers by default,
        # with a coordinated device takeover (and hand-back on lost
        # probation) across all metric scanners
        auto_mt = nworkers > 0 and getattr(scan_cls, 'AUTO_STREAM', False)

        def set_all_progress(done, total):
            for s in scanners:
                s.set_progress(done, total)
        progress_fn = set_all_progress \
            if any(hasattr(s, 'set_progress') for s in scanners) else None

        def process_main(provider, weights, n):
            alive0 = None
            if ds_pred is not None:
                alive0 = _eval_ds_filter(ds_pred, ds_stage, provider, n)
            if stack is not None:
                stack.process(provider, weights, alive0)
            else:
                for s in scanners:
                    s._process(provider, weights, alive=alive0)

        if use_mt or auto_mt:
            def build_worker(wp):
                wpred, wstage, wscans, _ = make_scan_set(wp, VectorScan)
                recs = []
                for s in wscans:
                    s._defer_enabled = False   # drained per batch
                    rec = scan_mt.BatchRecorder(s.aggr.stage)
                    s.aggr = rec
                    recs.append(rec)

                def process(snap):
                    n = snap.batch_size()
                    provider = NativeColumns(
                        _RemappedParser(snap, remap) if skinner
                        else snap)
                    weights = _batch_weights(skinner, snap, n)
                    alive0 = None
                    if wpred is not None:
                        alive0 = _eval_ds_filter(wpred, wstage,
                                                 provider, n)
                    out = []
                    for s, rec in zip(wscans, recs):
                        s._process(provider, weights, alive=alive0)
                        out.append(rec.drain())
                    return out
                return process

            def new_executor():
                # one radix merge per metric scanner per executor epoch
                radixes = [scan_mt.RadixMerge(s) for s in scanners]

                def apply_result(results):
                    for radix, calls in zip(radixes, results):
                        radix.apply_calls(calls)

                def finish_fn():
                    for radix in radixes:
                        radix.finalize()
                return scan_mt.MTScanExecutor(nworkers, build_worker,
                                              apply_result, pipeline,
                                              stage_offset,
                                              finish_fn=finish_fn)

            def take_over():
                if not scanners[0].take_over_now():
                    return False
                # share the probe result so sibling scanners don't
                # each wait on their own probe thread
                for s in scanners[1:]:
                    s._backend_ok = scanners[0]._backend_ok
                    s.probe_status = scanners[0].probe_status
                return True

            def device_batch(dsrc, n):
                nlines, nbad = parser.counters()
                _bump_parse_counters(parser_stage, adapter_stage,
                                     nlines, nbad, n)
                process_main(NativeColumns(dsrc),
                             _batch_weights(skinner, parser, n), n)
                parser.reset_batch()
                if any(s._disabled for s in scanners):
                    # coordinated hand-back: all metric scanners leave
                    # the device together
                    for s in scanners:
                        s._flush()
                        s._disabled = True
                    return False
                return True

            def submit_batch(ex, n):
                snap = scan_mt.ParserSnapshot(parser, paths, hints, dicts)
                parser.reset_batch()
                _bump_parse_counters(parser_stage, adapter_stage,
                                     snap.nlines, snap.nbad, n)
                if auto_mt:
                    for s in scanners:
                        s.note_external_batch(n)
                    scanners[0].shadow_feed(snap, n)
                ex.submit(snap)

            if auto_mt:
                from .device_scan import DeviceScan
                dev = scanners[0].device
                # the audition replays every metric's scan, so the
                # measured rate reflects the whole build fan-out
                scanners[0].enable_shadow(
                    lambda: [DeviceScan(q, self.ds_timefield, Pipeline(),
                                        ds_filter=None, device=dev)
                             for q in queries],
                    lambda snap: NativeColumns(
                        _RemappedParser(snap, remap) if skinner
                        else snap),
                    lambda snap, n: _batch_weights(skinner, snap, n),
                    # production passes the shared ds-filter mask as a
                    # non-None alive; the replay must match that shape
                    make_alive=(
                        (lambda n: np.ones(n, dtype=bool))
                        if filter is not None else None))

            self._takeover_stream(
                files, parser, BATCH_SIZE, progress_fn, new_executor,
                submit_batch, take_over if auto_mt else None,
                lambda: src, device_batch)
        else:
            def flush():
                n = parser.batch_size()
                if n == 0:
                    return
                nlines, nbad = parser.counters()
                _bump_parse_counters(parser_stage, adapter_stage,
                                     nlines, nbad, n)
                process_main(NativeColumns(src),
                             _batch_weights(skinner, parser, n), n)
                parser.reset_batch()

            self._stream_native(files, parser, flush, BATCH_SIZE,
                                progress=progress_fn)
        nlines, nbad = parser.counters()
        if nlines:
            parser_stage.counters['ninputs'] = nlines
            parser_stage.counters['noutputs'] = nlines - nbad
            if nbad:
                parser_stage.counters['invalid json'] = nbad
        mod_byteparse.publish_counters(parser_stage, parser)
        return scanners

    def _takeover_stream(self, files, parser, batch_size, progress,
                         new_executor, submit_batch, take_over,
                         make_device_src, device_batch):
        """The MT-host / device takeover state machine shared by scan
        and build: batches go to the MT executor until take_over()
        (auto mode's escalation decision) fires, then to the device
        scanner(s) via device_batch; a False from device_batch (lost
        probation) drains back to a fresh MT executor.  Batch order —
        and therefore the aggregator's insertion order — is preserved
        across both transitions: the executor is fully drained before
        any device batch flushes, and the device accumulator is flushed
        before the next executor starts."""
        state = {'ex': new_executor(), 'src': None}

        def flush():
            n = parser.batch_size()
            if n == 0:
                return
            if state['ex'] is not None and take_over is not None and \
                    take_over():
                state['ex'].finish()
                state['ex'] = None
                state['src'] = make_device_src()
            if state['ex'] is None:
                if not device_batch(state['src'], n):
                    state['src'] = None
                    state['ex'] = new_executor()
                return
            submit_batch(state['ex'], n)

        try:
            self._stream_native(files, parser, flush, batch_size,
                                progress=progress)
        finally:
            if state['ex'] is not None:
                state['ex'].finish()

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

    # how many stdin points index_read routes to the sinks at a time:
    # large enough to amortize the bulk write, small enough that peak
    # memory stays flat however long the piped stream is
    INDEX_READ_CHUNK = 4096

    def index_read(self, metrics, interval, instream):
        """Read tagged json-skinner points (from stdin) and write index
        files, streaming in bounded chunks through the build's
        StreamingIndexWriter (host work: the points are already
        aggregated).  (reference: lib/datasource-file.js:729-746)"""
        error = self.check_index_args(interval, True, False)
        if error is not None:
            raise error
        pipeline = Pipeline()
        from . import index_build_mt as mod_ibmt
        from . import resources as mod_resources
        writer = mod_ibmt.StreamingIndexWriter(metrics, interval,
                                               self.ds_indexpath)
        with mod_resources.translate_pressure_errors('index-read'):
            try:
                chunk = []
                for rec in mod_ingest.iter_records(
                        mod_ingest.iter_stream_lines(instream),
                        'json-skinner', pipeline):
                    chunk.append(rec)
                    if len(chunk) >= self.INDEX_READ_CHUNK:
                        writer.write_points(chunk)
                        chunk = []
                if chunk:
                    writer.write_points(chunk)
                writer.finish()
            except BaseException:
                writer.abort()
                raise
        return ScanResult(pipeline)

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
        engine='vector' keeps them on the host; engine='auto' follows a
        persisted `iq:` verdict, auditions in a process whose CUDA is
        warm, and otherwise stays on the host
        (device_index.lane_decision).  (reference:
        lib/datasource-file.js:573-691)"""
        from . import device_index as mod_di
        _check_engine(engine)
        pipeline = Pipeline()
        root, timeformat, files = self.index_query_paths(
            query, interval, pipeline)

        if dry_run:
            return ScanResult(pipeline,
                              dry_run_files=[p for p, st in files])
        if engine in ('device', 'auto'):
            # no silent CPU under auto either: the device is resolved
            # (and CUDA required unless the CPU was asked for) up front
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

    def _stream_native(self, files, parser, flush, batch_size,
                       progress=None):
        """Feed the concatenated file bytes to the columnar parser,
        flushing a batch whenever enough records accumulate (partial
        trailing lines join across file boundaries — catstreams
        semantics).  The native parser parses the bulk of each read
        chunk in place (zero-copy span, parse_at) and only the
        carry-spanning line is stitched; the byte lane takes
        complete-line buffers from the shared joiner
        (ingest.iter_line_buffers).

        progress(bytes_done, bytes_total), when given, is called before
        each flush — auto mode's device-switch heuristic estimates
        remaining work from it (total is 0 when sizes are unknowable,
        e.g. character devices)."""
        # larger reads amortize the multithreaded parse's fork/join; the
        # cap bounds how far a batch can overshoot the flush threshold
        # (flush is only checked between reads).  DN_READ_SIZE overrides
        # (testing / IO tuning).
        readsz = min(1 << 24, (1 << 22) * getattr(parser, 'nthreads', 1))
        try:
            readsz = int(os.environ.get('DN_READ_SIZE', 0)) or readsz
        except ValueError:
            pass
        parse_at = getattr(parser, 'parse_at', None)
        total = 0
        for path, st in files:
            sz = getattr(st, 'st_size', 0) if st is not None else 0
            total += sz if sz and sz > 0 else 0
        state = {'done': 0}

        def counted_chunks():
            for chunk in _read_ahead(files, readsz):
                state['done'] += len(chunk)
                yield chunk

        if parse_at is None:
            for lbuf in mod_ingest.iter_line_buffers(counted_chunks()):
                parser.parse(lbuf)
                if parser.batch_size() >= batch_size:
                    if progress is not None:
                        progress(state['done'], total)
                    flush()
            if progress is not None:
                progress(state['done'], total)
            flush()
            return

        carry = b''
        for chunk in counted_chunks():
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
                parse_at(arr[start:].ctypes.data, nl + 1 - start)
            carry = chunk[nl + 1:]
            if parser.batch_size() >= batch_size:
                if progress is not None:
                    progress(state['done'], total)
                flush()
        if carry:
            parser.parse(carry)
        if progress is not None:
            progress(state['done'], total)
        flush()


def _make_parser(lane, proj, skinner, parser_stage, device):
    """(parser, provider source) for a projection [(path, date_hint,
    need_dict)] on the parse lane `lane`: the byte lane
    (byteparse.ByteParser; its parity kernel on `device` for the device
    lane) when it engaged, the C++ parser otherwise.  A requested but
    ineligible byte lane bumps a hidden counter on the parse stage.
    json-skinner reads `fields.<path>` plus `value`, and the source
    presents those under the unprefixed names.  One source per pass, so
    per-column caches persist across batches.  The parser's (paths,
    hints, dicts) ride on it as `projection` (the MT path snapshots
    batches by them)."""
    if skinner:
        paths = ['fields.' + p for p, h, d in proj] + ['value']
        hints = [h for p, h, d in proj] + [False]
        dicts = [d for p, h, d in proj] + [True]
    else:
        paths = [p for p, h, d in proj]
        hints = [h for p, h, d in proj]
        dicts = [d for p, h, d in proj]
    mod_byteparse.note_ineligible(parser_stage, lane)
    if lane.engaged:
        pdev = None
        if lane.lane == 'device':
            from .ops import resolve_device
            pdev = resolve_device(device)
        parser = mod_byteparse.ByteParser(paths, hints, dicts, device=pdev)
    else:
        parser = mod_native.NativeParser(paths, hints, dicts)
    parser.projection = (paths, hints, dicts)
    if not skinner:
        return parser, parser
    remap = {p: np_ for (p, h, d), np_ in zip(proj, paths)}
    return parser, _RemappedParser(parser, remap)


def _record_weight(value):
    """A record's point value with the vectorized paths' coercion
    (json-skinner values may be strings or garbage)."""
    if isinstance(value, int):
        return value
    value = float(weights_array([value])[0])
    return int(value) if value.is_integer() else value


def _check_engine(engine):
    if engine not in ENGINES:
        raise DNError('unknown scan engine "%s"' % engine)


def _route_doc(scanners):
    """Which engine answered a scan or build: the device scans' route
    records (device_scan.DeviceScan.route_doc), or the host engine's
    name.  One entry per metric scan."""
    return [s.route_doc() if hasattr(s, 'route_doc')
            else {'engine': type(s).__name__, 'escalated': False,
                  'device_batches': 0}
            for s in scanners]


class _Holder(object):
    """The datasource predicate's field registry (VectorPredicate
    records the fields its leaves read here)."""

    def __init__(self):
        self.raw_columns = {}
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
