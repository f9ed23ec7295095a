"""Multithreaded host scan: parse / engine pipelining and fan-out.

Counterpart of dragnet_tpu/scan_mt.py.  The native parser already
parallelizes the byte->column step across cores; this module overlaps
and parallelizes the *engine* step (predicate masks, bucketize,
segment-sum) with it:

    main thread:  read -> native parse -> snapshot columns -> work queue
    W workers:    snapshot -> VectorScan._process -> per-batch key list
    merger:       applies each batch's (key, weight) calls to the real
                  aggregators IN BATCH ORDER

Replaying batches in input order makes the result — including the
aggregator's insertion-ordered emission, which the goldens pin — byte-
identical to the sequential path, because the sequential engine also
inserts keys batch by batch in first-occurrence order.  Workers never
share mutable scan state: each owns its VectorScan instances (their
dictionaries and predicate tables), and decoded keys (real strings /
bucket ordinals) are what crosses threads.  Workers are plain numpy
VectorScans: none touches torch or the card.  Counter parity: each
worker bumps its own pipeline's stages, which mirror the main
pipeline's scan stages one-to-one and are summed into them at the end.

DN_SCAN_THREADS sets the worker count (auto = up to 6, bounded by CPU
count; 0 disables the executor entirely).  Workers adopt the submitting
request's counter scope (vpipe.adopt_scope), so a `dn serve` request's
counters and spans attribute to it; the fan-out reports one
`scan_mt.fanout` span.
"""

import os
import queue
import threading

import numpy as np

from .watchdog import LeakCheck

# an executor that is never finish()ed means submitted batches may
# never have merged into the result
_EXECUTOR_LEAKS = LeakCheck(
    'scan executor(s) never drained; results may be incomplete',
    lambda ex: not ex.closed)


def scan_threads():
    v = os.environ.get('DN_SCAN_THREADS', 'auto')
    if v != 'auto':
        try:
            return max(0, int(v))
        except ValueError:
            return 0
    return max(1, min(6, os.cpu_count() or 1))


def scan_partitions():
    """Radix partition count for the MT merge (DN_SCAN_PARTITIONS;
    auto = up to 8, bounded by CPU count)."""
    v = os.environ.get('DN_SCAN_PARTITIONS', 'auto')
    if v != 'auto':
        try:
            return max(1, int(v))
        except ValueError:
            pass
    return max(1, min(8, os.cpu_count() or 1))


class PinnedList(object):
    """Fixed-length view of an append-only list.  The parser's Python
    dictionary mirrors only ever grow; pinning the length makes a
    worker's iteration/len/slicing immune to appends the main thread
    performs for later batches (entries below the pin are immutable)."""

    __slots__ = ('_lst', '_n')

    def __init__(self, lst, n):
        self._lst = lst
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._lst[:self._n][i]
        if i >= self._n or i < -self._n:
            raise IndexError(i)
        # resolve negatives against the pinned length, not the live list
        return self._lst[i + self._n] if i < 0 else self._lst[i]

    def __iter__(self):
        lst = self._lst
        for i in range(self._n):
            yield lst[i]


class ParserSnapshot(object):
    """Immutable copy of one parsed batch, safe to hand to a worker
    while the main thread keeps parsing.  Column arrays are fresh copies
    (NativeParser.columns copies out of the C buffers); dictionaries are
    length-pinned views of the parser's append-only Python mirrors —
    codes in this batch only reference entries below the pin.

    need_dicts marks the paths whose dictionary the engine may read;
    date-only sources are consumed via the pre-parsed date columns, and
    mirroring their dictionaries (one entry per distinct timestamp —
    nearly one per record) would dominate the whole scan."""

    def __init__(self, parser, paths, hints, need_dicts=None):
        if need_dicts is None:
            need_dicts = [True] * len(paths)
        self._n = parser.batch_size()
        self._cols = {}
        self._dates = {}
        self._dicts = {}
        for p, h, nd in zip(paths, hints, need_dicts):
            if nd:
                self._cols[p] = parser.columns(p)
                d = parser.dictionary(p)
                self._dicts[p] = PinnedList(d, len(d))
            if h:
                self._dates[p] = parser.date_columns(p)
        self.nlines, self.nbad = parser.counters()
        # share the engine's decoded-array-values cache across batches:
        # it lives on the persistent parser, every snapshot aliases it
        # (engine keys entries by dictionary length, so concurrent
        # readers at older pins stay correct — extra entries decode to
        # codes their batch never contains)
        cache = getattr(parser, '_array_cache', None)
        if cache is None:
            cache = {}
            parser._array_cache = cache
        self._array_cache = cache

    def batch_size(self):
        return self._n

    def columns(self, path):
        return self._cols[path]

    def date_columns(self, path):
        return self._dates[path]

    def dictionary(self, path):
        return self._dicts[path]

    # -- device-path accessors (lazy; only the shadow audition's device
    # staging calls these — worker host scans never do).  Semantics
    # mirror NativeParser's native one-pass accessors exactly, so a
    # batch staged from a snapshot has the SAME upload profile as the
    # production batch staged from the live parser — without this, an
    # audition would time the use_dstats=False variant production
    # never runs.

    def field_stats(self, path):
        cache = getattr(self, '_fstats', None)
        if cache is None:
            cache = self._fstats = {}
        st = cache.get(path)
        if st is None:
            import numpy as np
            from . import native as mod_native
            tags, nums, strcodes = self._cols[path]
            m = (tags == mod_native.TAG_INT) | \
                (tags == mod_native.TAG_NUMBER)
            nnum = int(m.sum())
            nstr = int((tags == mod_native.TAG_STRING).sum())
            narr = int((tags == mod_native.TAG_ARRAY).sum())
            i32ok = True
            nmn = nmx = 0.0
            if nnum:
                nm = nums[m]
                nmn = float(nm.min())
                nmx = float(nm.max())
                i32ok = bool(np.all(np.isfinite(nm)) and
                             np.all(nm == np.floor(nm)) and
                             nmn >= -(2 ** 31) and
                             nmx <= 2 ** 31 - 1)
            st = (narr, i32ok, nmn, nmx, nnum, nstr)
            cache[path] = st
        return st

    def tags_col(self, path):
        return self._cols[path][0]

    def strcodes_col(self, path):
        return self._cols[path][2]

    def nums_i32(self, path):
        import numpy as np
        from . import native as mod_native
        tags, nums, _ = self._cols[path]
        m = (tags == mod_native.TAG_INT) | \
            (tags == mod_native.TAG_NUMBER)
        # valid only after field_stats reported all_nums_i32, same
        # contract as the native accessor
        return np.where(m, nums, 0.0).astype(np.int64).astype(np.int32)

    def date_stats(self, path):
        d = self._dates.get(path)
        if d is None:
            return None
        import numpy as np
        secs, err = d
        ok = err == 0
        n_ok = int(ok.sum())
        if n_ok:
            so = secs[ok]
            all_i32 = bool(np.all(np.isfinite(so)) and
                           np.all(so == np.floor(so)) and
                           so.min() >= -(2 ** 31) and
                           so.max() <= 2 ** 31 - 1)
        else:
            all_i32 = True
        return (all_i32, n_ok)

    def date_i32(self, path):
        import numpy as np
        secs, err = self._dates[path]
        return np.where(err == 0, secs,
                        0.0).astype(np.int64).astype(np.int32)

    def date_err(self, path):
        return self._dates[path][1]


class BatchRecorder(object):
    """Aggregator stand-in for worker scans: records write_key calls in
    order so the merger can replay them into the real aggregator."""

    def __init__(self, stage):
        self.stage = stage
        self.calls = []

    def write_key(self, keys, value):
        self.calls.append((keys, value))

    def write_columnar(self, gcols, wvals, bcols):
        """Columnar emission from a worker's _emit_unique: raw global
        code columns + dense weight sums, no per-tuple Python decode.
        `bcols` is the worker scan's _breakdown_cols — the merger needs
        the worker's column objects to translate string codes into the
        main scanner's dictionaries.  keys=None marks the entry so the
        replay can tell it from a decoded write_key call."""
        self.calls.append((None, (gcols, wvals, bcols)))

    def drain(self):
        calls = self.calls
        self.calls = []
        return calls


# -- radix-partitioned merge -------------------------------------------------

# merge-phase telemetry accumulated across RadixMerge finalizations
# (bench reads the scan/merge time split from here; reset per leg)
_MERGE_STATS = {'merge_ms': 0.0, 'partitions': 0, 'rows': 0,
                'unique': 0, 'engaged': 0}
_MERGE_LOCK = threading.Lock()


def reset_merge_stats():
    with _MERGE_LOCK:
        _MERGE_STATS.update(merge_ms=0.0, partitions=0, rows=0,
                            unique=0, engaged=0)


def merge_stats():
    with _MERGE_LOCK:
        return dict(_MERGE_STATS)


_M1 = np.uint64(0xff51afd7ed558ccd)
_M2 = np.uint64(0xc4ceb9fe1a85ec53)
_S33 = np.uint64(33)


def _mix64(x):
    """splitmix64-style finalizer, vectorized (uint64 wraparound)."""
    x = x ^ (x >> _S33)
    x = x * _M1
    x = x ^ (x >> _S33)
    x = x * _M2
    return x ^ (x >> _S33)


def _hash_partition(cols, nparts):
    """Deterministic partition id per row from its code tuple.  The
    codes are MAIN-dictionary codes (translated before hashing), so a
    given key tuple always lands in the same partition regardless of
    which worker produced it."""
    h = np.zeros(len(cols[0]), dtype=np.uint64)
    for arr in cols:
        h = _mix64(h ^ _mix64(arr.astype(np.uint64)))
    return (h % np.uint64(nparts)).astype(np.int64)


class RadixMerge(object):
    """Radix-partitioned aggregation for the MT merger: replaces the
    serial per-tuple write_key funnel for high-cardinality scans.

    Workers emit raw (code columns, weight sums) per batch
    (BatchRecorder.write_columnar); the merger thread translates worker
    string codes into the main scanner's dictionaries (vectorized,
    cached per worker column — the append-only-dictionary idiom of
    engine._native_str_trans), hash-partitions the fused keys into P
    disjoint partitions, and buffers rows per partition tagged with
    their global arrival position.  finalize() compacts the partitions
    in parallel (unique + weight bincount per partition — no
    cross-partition contention), restores global first-occurrence
    order by the recorded positions, and hands the scanner ONE columnar
    emission.

    Byte-identity with the serial merge: partition extraction is a
    stable filter of the seq-ordered row stream, np.bincount folds
    weights in array index order, and compaction partials land at
    first-occurrence positions — every weight is a left-fold of the
    same batch partials in the same global order the serial replay
    added them, and the final argsort by arrival position reproduces
    the global first-occurrence key order exactly.

    Small batches (< engine.DEFER_UNIQUE uniques) stay on the decoded
    write_key path until the first columnar batch engages the radix
    buffer; after that every call routes through it so seq order is
    preserved end to end."""

    # compact a partition's buffer once it holds this many rows
    # (memory stays bounded by unique tuples, engine._defer_compact's
    # discipline applied per partition)
    PART_COMPACT_ROWS = 1 << 20

    def __init__(self, scanner, npartitions=None):
        self.scanner = scanner
        self.npartitions = int(npartitions or scan_partitions())
        self.engaged = False
        self.rows_in = 0
        self.merge_ms = 0.0
        self._gpos = 0
        self._ncols = len(scanner._breakdown_cols)
        self._parts = None

    # -- merger-thread entry ------------------------------------------------

    def apply_calls(self, calls):
        """Replay one worker batch's recorded calls in order (runs on
        the merger thread, batches arrive in seq order)."""
        import time as mod_time
        write_key = self.scanner.aggr.write_key
        pend = None
        for keys, payload in calls:
            if keys is None:
                if pend:
                    self._add_key_batch(pend)
                    pend = None
                t0 = mod_time.perf_counter()
                self._add_columnar(*payload)
                self.merge_ms += (mod_time.perf_counter() - t0) * 1e3
            elif not self.engaged:
                write_key(keys, payload)
            else:
                if pend is None:
                    pend = []
                pend.append((keys, payload))
        if pend:
            self._add_key_batch(pend)

    def _add_columnar(self, gcols, wvals, wbcols):
        cols = []
        for (kind, mcol), (_, wcol), arr in zip(
                self.scanner._breakdown_cols, wbcols, gcols):
            arr = np.asarray(arr, dtype=np.int64)
            if kind == 'str':
                arr = _translate_codes(wcol, mcol, arr)
            cols.append(arr)
        self._append(cols, np.asarray(wvals, dtype=np.float64))

    def _add_key_batch(self, items):
        """Decoded (keys, value) calls arriving after engagement: encode
        into main-dictionary codes and append in seq order, so late
        small batches keep their place in the global order."""
        import time as mod_time
        t0 = mod_time.perf_counter()
        n = len(items)
        cols = [np.empty(n, dtype=np.int64) for _ in range(self._ncols)]
        w = np.empty(n, dtype=np.float64)
        encoders = [(col.dict.code if kind == 'str' else None)
                    for kind, col in self.scanner._breakdown_cols]
        for i, (keys, v) in enumerate(items):
            for ci, (enc, k) in enumerate(zip(encoders, keys)):
                cols[ci][i] = enc(k, k) if enc is not None else k
            w[i] = v
        self._append(cols, w)
        self.merge_ms += (mod_time.perf_counter() - t0) * 1e3

    # -- partition buffers --------------------------------------------------

    def _append(self, cols, w):
        if not self.engaged:
            self.engaged = True
            self._parts = [([[] for _ in range(self._ncols)], [], [],
                            [0]) for _ in range(self.npartitions)]
        n = len(w)
        pos = np.arange(self._gpos, self._gpos + n, dtype=np.int64)
        self._gpos += n
        self.rows_in += n
        if self.npartitions <= 1:
            self._append_part(0, cols, w, pos)
            return
        pid = _hash_partition(cols, self.npartitions)
        for p in np.unique(pid):
            m = pid == p
            self._append_part(int(p), [c[m] for c in cols], w[m],
                              pos[m])

    def _append_part(self, p, cols, w, pos):
        ccols, cw, cpos, nrows = self._parts[p]
        for lst, arr in zip(ccols, cols):
            lst.append(arr)
        cw.append(w)
        cpos.append(pos)
        nrows[0] += len(w)
        if nrows[0] > self.PART_COMPACT_ROWS:
            self._parts[p] = self._compact_part(self._parts[p])

    def _compact_part(self, part):
        """Unique + weight-sum one partition's buffered rows,
        first-occurrence order (ascending buffer index == ascending
        global position) preserved — engine._defer_compact per
        partition, with the arrival positions riding along."""
        from .engine import _unique_rows
        ccols, cw, cpos, nrows = part
        gcols = [c[0] if len(c) == 1 else np.concatenate(c)
                 for c in ccols]
        w = cw[0] if len(cw) == 1 else np.concatenate(cw)
        pos = cpos[0] if len(cpos) == 1 else np.concatenate(cpos)
        first_idx, inv, order = _unique_rows(gcols)
        wsum = np.bincount(inv, weights=w, minlength=len(first_idx))
        rows = first_idx[order]
        return ([[arr[rows]] for arr in gcols], [wsum[order]],
                [pos[rows]], [len(rows)])

    # -- finalization -------------------------------------------------------

    def finalize(self):
        """Compact every partition (in parallel — numpy's sorts release
        the GIL), stitch the partitions back into global
        first-occurrence order, and emit once into the main scanner."""
        import time as mod_time
        from .obs import metrics as obs_metrics
        if not self.engaged:
            return
        t0 = mod_time.perf_counter()
        parts = self._parts
        self._parts = None
        live = [p for p in range(self.npartitions) if parts[p][3][0]]
        results = [None] * self.npartitions
        errors = []

        def work(p):
            try:
                results[p] = self._compact_part(parts[p])
            except BaseException as e:
                errors.append(e)

        if len(live) > 1:
            threads = [threading.Thread(target=work, args=(p,))
                       for p in live[1:]]
            for t in threads:
                t.start()
            work(live[0])
            for t in threads:
                t.join()
        elif live:
            work(live[0])
        if errors:
            raise errors[0]
        merged = [results[p] for p in live]
        nuniq = 0
        if merged:
            cols = [np.concatenate([r[0][i][0] for r in merged])
                    for i in range(self._ncols)]
            w = np.concatenate([r[1][0] for r in merged])
            pos = np.concatenate([r[2][0] for r in merged])
            order = np.argsort(pos, kind='stable')
            nuniq = len(w)
            self.scanner._emit_unique([c[order] for c in cols],
                                      w[order])
        self.engaged = False
        ms = (mod_time.perf_counter() - t0) * 1e3 + self.merge_ms
        with _MERGE_LOCK:
            _MERGE_STATS['merge_ms'] += ms
            _MERGE_STATS['partitions'] = self.npartitions
            _MERGE_STATS['rows'] += self.rows_in
            _MERGE_STATS['unique'] += nuniq
            _MERGE_STATS['engaged'] += 1
            obs_metrics.set_gauge('scan_merge_partitions',
                                  self.npartitions)
            obs_metrics.set_gauge('scan_merge_ms',
                                  _MERGE_STATS['merge_ms'])


def _translate_codes(wcol, mcol, codes):
    """Worker-dictionary string codes -> main-dictionary codes, via an
    incremental translation array cached on the worker column (both
    dictionaries are append-only; merger-thread only).  Worker threads
    may append to wcol's dictionary concurrently, but list appends are
    atomic and codes in a delivered batch only reference entries that
    existed when the batch was produced."""
    cached = getattr(wcol, '_radix_trans', None)
    if cached is None or cached[0] is not mcol:
        cached = (mcol, np.zeros(0, dtype=np.int64))
    trans = cached[1]
    values = wcol.dict.values
    hi = len(values)
    if hi > len(trans):
        code = mcol.dict.code
        new = np.array([code(s, s) for s in values[len(trans):hi]],
                       dtype=np.int64)
        trans = np.concatenate([trans, new]) if len(trans) else new
        wcol._radix_trans = (mcol, trans)
    return trans[codes]


class MTScanExecutor(object):
    """Generic fan-out: enqueue snapshots, run build_worker()'s process
    function on them across nworkers threads, apply results in order.

    build_worker() -> (process, finish) runs once per worker thread:
    process(snapshot) returns a result object, finish(worker_pipeline)
    is unused state capture (the pipeline is merged by the executor).
    apply_result(result) runs on the merger thread in sequence order.
    """

    QUEUE_DEPTH = 4

    def __init__(self, nworkers, build_worker, apply_result,
                 main_pipeline, stage_offset, finish_fn=None):
        import time as mod_time
        from .vpipe import Pipeline
        self.closed = False
        self._t0 = mod_time.perf_counter()
        _EXECUTOR_LEAKS.track(self)
        self.nworkers = nworkers
        self.apply_result = apply_result
        self.finish_fn = finish_fn
        self.main_pipeline = main_pipeline
        self.stage_offset = stage_offset
        self.workq = queue.Queue(maxsize=self.QUEUE_DEPTH + nworkers)
        self.resultq = queue.Queue()
        self.errors = []
        self.seq = 0
        self.worker_pipelines = []
        # workers adopt the submitting request's counter scope so the
        # hidden parse/engine telemetry their pipelines mirror still
        # attributes to the right `dn serve` request
        from . import vpipe as mod_vpipe
        self._scope = mod_vpipe.current_scope()
        self.threads = []
        for _ in range(nworkers):
            wp = Pipeline()
            self.worker_pipelines.append(wp)
            t = threading.Thread(target=self._worker,
                                 args=(build_worker, wp), daemon=True)
            t.start()
            self.threads.append(t)
        self.merger = threading.Thread(target=self._merge, daemon=True)
        self.merger.start()

    def _worker(self, build_worker, wp):
        from . import vpipe as mod_vpipe
        with mod_vpipe.adopt_scope(self._scope):
            self._worker_loop(build_worker, wp)

    def _worker_loop(self, build_worker, wp):
        import time as mod_time
        from .obs import metrics as obs_metrics
        try:
            process = build_worker(wp)
        except BaseException as e:  # surface setup failures at submit
            self.errors.append(e)
            process = None
        while True:
            item = self.workq.get()
            if item is None:
                return
            seq, snap = item
            if self.errors:
                self.resultq.put((seq, None))
                continue
            try:
                t0 = mod_time.perf_counter()
                result = process(snap)
                obs_metrics.observe(
                    'scan_batch_ms',
                    (mod_time.perf_counter() - t0) * 1000.0)
                self.resultq.put((seq, result))
            except BaseException as e:
                self.errors.append(e)
                self.resultq.put((seq, None))

    def _merge(self):
        pending = {}
        want = 0
        while True:
            item = self.resultq.get()
            if item is None:
                return
            seq, result = item
            pending[seq] = result
            while want in pending:
                result = pending.pop(want)
                want += 1
                if result is None or self.errors:
                    continue
                try:
                    self.apply_result(result)
                except BaseException as e:
                    self.errors.append(e)

    def submit(self, snapshot):
        if self.errors:
            self.close()
            raise self.errors[0]
        self.workq.put((self.seq, snapshot))
        self.seq += 1

    def close(self):
        self.closed = True
        for _ in self.threads:
            self.workq.put(None)
        for t in self.threads:
            t.join()
        self.resultq.put(None)
        self.merger.join()
        self.threads = []

    def finish(self):
        """Drain everything, merge worker counters into the main
        pipeline, and re-raise the first worker error."""
        import time as mod_time
        from .obs import trace as obs_trace
        self.close()
        # one synthesized span for the whole fan-out (per-batch latency
        # lives in the always-on scan_batch_ms histogram instead)
        obs_trace.add_span(
            'scan_mt.fanout',
            (mod_time.perf_counter() - self._t0) * 1000.0,
            nworkers=self.nworkers, batches=self.seq)
        if self.errors:
            raise self.errors[0]
        if self.finish_fn is not None:
            # drain any merge-side buffers (the radix merge) into the
            # main scanner BEFORE the caller proceeds — a device
            # takeover right after finish() must observe every batch
            # this executor owned, in order
            self.finish_fn()
        main_stages = self.main_pipeline.stages[self.stage_offset:]
        for wp in self.worker_pipelines:
            assert len(wp.stages) <= len(main_stages)
            for ms, ws in zip(main_stages, wp.stages):
                assert ms.name == ws.name
                for counter, value in ws.counters.items():
                    ms.bump(counter, value)
