"""File-backend scan: input enumeration, the native parse stream and the
scan engine.

Counterpart of dragnet_tpu/datasource_file.py `DatasourceFile.scan`,
restricted to the native-parser lane (native/dnparse.cc) and its
single-threaded engine step: input enumeration (strftime-pruned when the
datasource has a time format), one pass over the concatenated file
bytes (a partial trailing line joins across file boundaries), batches
fed to the device scan (device_scan.py) or, when asked for, the host
engine (engine.VectorScan).
"""

import os

import numpy as np

from .errors import DNError
from . import ingest as mod_ingest
from . import find as mod_find
from . import native as mod_native
from .engine import BATCH_SIZE, VectorScan
from .vpipe import Pipeline

ENGINES = ('device', 'vector')


def create_datasource(dsconfig):
    assert dsconfig['ds_backend'] == 'file'
    if not isinstance(dsconfig['ds_backend_config'].get('path'), str):
        return DNError('expected datasource "path" to be a string')
    return DatasourceFile(dsconfig)


class ScanResult(object):
    def __init__(self, pipeline, points):
        self.pipeline = pipeline
        self.points = points


class DatasourceFile(object):
    def __init__(self, dsconfig):
        bc = dsconfig['ds_backend_config']
        self.ds_format = dsconfig.get('ds_format')
        self.ds_timeformat = bc.get('timeFormat')
        self.ds_timefield = bc.get('timeField')
        self.ds_datapath = bc['path']
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
        if engine not in ENGINES:
            raise DNError('unknown scan engine "%s"' % engine)
        pipeline = Pipeline()
        ctx = self._scan_init(query.qc_after, query.qc_before, pipeline)
        if isinstance(ctx, DNError):
            raise ctx
        files, fmt = ctx
        if mod_native.get_lib() is None:
            raise DNError('native parser (native/dnparse.cc) unavailable: '
                          'build it with "make -C native"')
        # parse stages first: --counters lists stages in creation order
        stages = mod_ingest.make_parser_stages(pipeline, fmt)
        if engine == 'device':
            from .device_scan import DeviceScan
            scanner = DeviceScan(query, self.ds_timefield, pipeline,
                                 ds_filter=self.ds_filter, device=device)
        else:
            scanner = VectorScan(query, self.ds_timefield, pipeline,
                                 ds_filter=self.ds_filter)
        self._scan_native(scanner, files, fmt, stages)
        scanner.finish()
        return ScanResult(pipeline, scanner.aggr.points())

    def _scan_native(self, scanner, files, fmt, stages):
        """Scan via the C++ columnar parser: one pass over the
        concatenated bytes, projected fields only, batched into the
        engine."""
        parser_stage, adapter_stage = stages

        skinner = fmt == 'json-skinner'
        proj = scanner.projection()
        if skinner:
            paths = ['fields.' + p for p, h, d in proj] + ['value']
            hints = [h for p, h, d in proj] + [False]
            dicts = [d for p, h, d in proj] + [True]
        else:
            paths = [p for p, h, d in proj]
            hints = [h for p, h, d in proj]
            dicts = [d for p, h, d in proj]
        parser = mod_native.NativeParser(paths, hints, dicts)
        remap = {p: np_ for p, np_ in
                 zip([p for p, h, d in proj], paths)} if skinner \
            else None

        # one provider for the whole scan so per-column caches
        # (decoded array values etc.) persist across batches
        src = _RemappedParser(parser, remap) if skinner else parser

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
