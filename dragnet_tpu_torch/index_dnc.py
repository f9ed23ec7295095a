"""DNC: the native columnar index store (default index engine).

The reference's only native component was the sqlite3 binding storing
aggregated points in SQLite tables (lib/index-sink.js,
lib/index-query.js).  DNC replaces the storage engine while keeping
every observable contract: the same embedded config pairs (version
2.0.0, dn_start), the same metric catalog strings, the same
filter/GROUP-BY/SUM semantics (including SQLite's type-affinity
conversions and BINARY-collation text ordering), the same atomic
tmp+rename artifact, and the same `.sqlite`-named file layout —
readers dispatch on content (index_query.open_index).

Layout (see native/dnindex.cc for the byte-level spec): one
memory-mapped file of 8-byte-aligned column blocks — i64 columns for
aggregated breakdowns, dictionary-encoded text columns otherwise, an
f64 value column with per-row integrality flags — plus a JSON footer
with per-table descriptors.  Queries evaluate the predicate AST as
vectorized numpy masks over the mapped columns and push the GROUP
BY/SUM into the C++ kernel (dictionary codes are translated to
byte-order ranks first, so ascending rank order equals SQLite's sort
order).  Both halves degrade gracefully: without the shared library the
same format is written and read via mmap + numpy.

Values that SQLite's column affinity would store heterogeneously (text
in an integer column, non-integral reals) fall back to the SQLite
engine for that file — readers sniff per file, so mixed trees work.
"""

import json
import mmap
import os
import re
import struct

import numpy as np

from . import jsvalues as jsv
from . import native_index
from .errors import DNError
from .index_query import IndexQuerierBase
from .index_sink import (IndexSink, INDEX_VERSION, check_block,
                         metric_catalog_rows, point_metric, point_row,
                         sqlite3_escape)


class _Incompatible(Exception):
    """A value SQLite affinity rules would store with a different
    storage class than the column's DNC kind supports."""


# ---------------------------------------------------------------------------
# SQLite affinity conversions
# ---------------------------------------------------------------------------

def _sqlite_real_text(v):
    """REAL -> TEXT as SQLite's %!.15g renders it: 15 significant
    digits and a mantissa that always carries a decimal point ('2.0'
    not '2', '1.0e+20' not '1e+20'); negative zero prints '0.0'."""
    if v == 0:
        return '0.0'
    if v != v:
        return None  # NaN stores as NULL
    if v in (float('inf'), float('-inf')):
        return 'Inf' if v > 0 else '-Inf'
    s = '%.15g' % v
    mant, e, exp = s.partition('e')
    if '.' not in mant:
        mant += '.0'
    return mant + e + exp


def _text_affinity(v):
    """What SQLite stores for `v` in a TEXT-affinity column."""
    if v is None:
        return None
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return '1' if v else '0'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _sqlite_real_text(v)
    raise _Incompatible()


def _int_affinity(v):
    """What SQLite stores for `v` in an INTEGER-affinity column, when
    that is an integer; otherwise (REAL, TEXT, NULL storage)
    _Incompatible — the file falls back to the SQLite engine."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        if -(2 ** 63) <= v < 2 ** 63:
            return v
        raise _Incompatible()
    if isinstance(v, float):
        if v.is_integer() and -(2 ** 63) <= v < 2 ** 63:
            return int(v)
        raise _Incompatible()
    if isinstance(v, str):
        # lossless-and-reversible text->int conversion only
        try:
            iv = int(v)
        except ValueError:
            raise _Incompatible()
        if str(iv) == v and -(2 ** 63) <= iv < 2 ** 63:
            return iv
        raise _Incompatible()
    raise _Incompatible()


def _value_affinity(v):
    """(float value, isint flag) for the `value integer` column."""
    if isinstance(v, bool):
        return (float(v), 1)
    if isinstance(v, int):
        return (float(v), 1)
    if isinstance(v, float):
        if v.is_integer():
            return (float(v), 1)  # INTEGER affinity converts 2.0 -> 2
        return (v, 0)
    if isinstance(v, str):
        f = jsv.to_number(v)
        if f != f:
            raise _Incompatible()  # non-numeric text stays TEXT
        return _value_affinity(f if not f.is_integer() else int(f))
    raise _Incompatible()


def _sqlite_text_to_num(s):
    """NUMERIC affinity applied to a text operand for comparison: the
    numeric value when `s` is a well-formed literal, else None."""
    t = s.strip(' \t\n\r\f\v')
    if not re.fullmatch(r'[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?', t):
        return None
    f = float(t)
    if f.is_integer() and abs(f) < 2 ** 63 and \
            re.fullmatch(r'[+-]?\d+', t):
        return int(t)
    return f


def _encode_text(s):
    return s.encode('utf-8', 'surrogatepass')


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _NativeFileWriter(object):
    def __init__(self, lib, path):
        self.lib = lib
        self.h = lib.dn_idx_writer_create(path.encode())
        if not self.h:
            raise DNError('cannot create index file "%s"' % path)

    def block(self, data):
        off = self.lib.dn_idx_writer_block(self.h, data, len(data))
        if off < 0:
            self.lib.dn_idx_writer_abort(self.h)
            self.h = None
            raise DNError('index write failed')
        return off

    def finalize(self, footer):
        rv = self.lib.dn_idx_writer_finalize(self.h, footer, len(footer))
        self.h = None
        if rv != 0:
            raise DNError('index finalize failed')

    def discard(self):
        """Release the native handle without finalizing (error path)."""
        if self.h is not None:
            self.lib.dn_idx_writer_abort(self.h)
            self.h = None


class _PyFileWriter(object):
    """Same byte layout, plain Python I/O (no-toolchain fallback)."""

    def __init__(self, path):
        self.f = open(path, 'wb')
        self.f.write(native_index.MAGIC)
        self.f.write(struct.pack('<II', native_index.FORMAT_VERSION, 0))
        self.f.write(struct.pack('<qq', 0, 0))
        self.off = native_index.HEADER_SIZE

    def block(self, data):
        pad = (8 - (self.off & 7)) & 7
        if pad:
            self.f.write(b'\0' * pad)
            self.off += pad
        at = self.off
        self.f.write(data)
        self.off += len(data)
        return at

    def finalize(self, footer):
        at = self.block(footer)
        self.f.seek(16)
        self.f.write(struct.pack('<qq', at, len(footer)))
        self.f.close()

    def discard(self):
        """Close without finalizing (error path)."""
        try:
            self.f.close()
        except Exception:
            pass


class DncIndexSink(object):
    """Drop-in for index_sink.IndexSink writing the DNC format.

    Points are buffered columnarly — one Python list per column, plus
    the value column — so the bulk write_rows path is a straight
    list.extend with no per-row tuple objects; the buffer count stays
    bounded by unique aggregate tuples, the reference's own memory
    model.  Typed arrays are built at flush and the file appears
    atomically via tmp+rename."""

    def __init__(self, metrics, filename, config=None, catalog=None,
                 tmp_suffix=None):
        from . import faults as mod_faults
        mod_faults.fire('sink.create')
        self.is_metrics = metrics
        self.is_dbfilename = filename
        self.is_dbtmpfilename = filename + '.' + \
            (tmp_suffix or str(os.getpid()))
        self._tmp_suffix = tmp_suffix
        self.is_config = dict(config or {})
        self.is_nwritten = 0
        self._prepared = False
        self._delegate = None     # _Incompatible fallback: IndexSink
        self._catalog = catalog
        self._names = [[b['b_name'] for b in m.m_breakdowns]
                       for m in metrics]
        self._keycols = [[[] for _ in names] for names in self._names]
        self._vals = [[] for _ in metrics]

        dirname = os.path.dirname(self.is_dbtmpfilename)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    def write(self, fields, value):
        # hot loop: one call per aggregated point
        mi = point_metric(fields, len(self.is_metrics))
        row = point_row(fields, self._names[mi])
        for col, v in zip(self._keycols[mi], row):
            col.append(v)
        self._vals[mi].append(value)
        self.is_nwritten += 1

    def write_rows(self, mi, keycols, values):
        """Bulk append one metric's block: `keycols` is one column per
        breakdown (in breakdown order), `values` the value column —
        the direct columnar append the build fan-out uses."""
        check_block(mi, keycols, self._names)
        for col, src in zip(self._keycols[mi], keycols):
            col.extend(src)
        self._vals[mi].extend(values)
        self.is_nwritten += len(values)

    @staticmethod
    def _array_of(raw):
        """np.asarray that degrades to None instead of raising (huge
        ints overflow, ragged values) — the vectorized fast paths
        dispatch on the result's dtype and fall back per-element."""
        try:
            arr = np.asarray(raw)
        except (ValueError, TypeError, OverflowError):
            return None
        return arr

    def _columnarize(self):
        """Convert buffered columns to typed arrays; _Incompatible when
        a value needs a storage class the column kind cannot hold."""
        tables = []
        for mi, m in enumerate(self.is_metrics):
            rawvals = self._vals[mi]
            n = len(rawvals)
            cols = []
            for ci, b in enumerate(m.m_breakdowns):
                name = sqlite3_escape(b['b_name'])
                raw = self._keycols[mi][ci]
                if 'b_aggr' in b:
                    # the usual case — pure Python ints (bucket
                    # ordinals, aggregated fields) — converts at C
                    # speed; anything else (floats, bools, text,
                    # out-of-range) takes the exact affinity loop
                    arr = self._array_of(raw)
                    if arr is None or arr.dtype != np.int64:
                        arr = np.fromiter(
                            (_int_affinity(v) for v in raw),
                            dtype=np.int64, count=n)
                    cols.append((name, 'i64', arr))
                else:
                    codes = np.empty(n, dtype=np.int32)
                    index = {}
                    values = []
                    for i, t in enumerate(raw):
                        if type(t) is not str:  # fast path: usual case
                            t = _text_affinity(t)
                            if t is None:
                                codes[i] = -1
                                continue
                        c = index.get(t)
                        if c is None:
                            c = len(values)
                            index[t] = c
                            values.append(t)
                        codes[i] = c
                    cols.append((name, 'str', (codes, values)))
            varr = self._array_of(rawvals)
            if varr is not None and varr.dtype == np.int64:
                # all-integer weights: INTEGER affinity, flags all set
                vals = varr.astype(np.float64)
                flags = np.ones(n, dtype=np.uint8)
            elif varr is not None and varr.dtype == np.float64:
                # int/float mix: same float64 image the per-element
                # loop stored; integral (finite) values flag as ints,
                # exactly _value_affinity's is_integer rule
                vals = varr
                flags = (np.isfinite(varr)
                         & (varr == np.floor(varr))).astype(np.uint8)
            else:
                vals = np.empty(n, dtype=np.float64)
                flags = np.empty(n, dtype=np.uint8)
                for i, v in enumerate(rawvals):
                    if type(v) is int:  # fast path: integer weights
                        vals[i] = v
                        flags[i] = 1
                    else:
                        vals[i], flags[i] = _value_affinity(v)
            tables.append((n, cols, vals, flags))
        return tables

    def _prepare_sqlite(self):
        """A value needs a storage class DNC cannot hold: replay the
        buffered columns into the SQLite engine instead (readers sniff
        per file, so mixed trees work).  The delegate sink carries the
        same tmp name, so two-phase callers and the recovery sweep see
        one tmp whichever engine wrote it."""
        sink = IndexSink(self.is_metrics, self.is_dbfilename,
                         config=self.is_config, catalog=self._catalog,
                         tmp_suffix=self._tmp_suffix)
        for mi in range(len(self.is_metrics)):
            sink.write_rows(mi, self._keycols[mi], self._vals[mi])
        sink.prepare()
        self._delegate = sink

    def prepare(self):
        """Phase 1: the complete shard body lands in the tmp file (see
        index_sink.IndexSink.prepare)."""
        from . import faults as mod_faults
        mod_faults.fire('sink.flush', torn_path=self.is_dbtmpfilename)
        try:
            tables = self._columnarize()
            configpairs = [('version', INDEX_VERSION)]
            for k, v in self.is_config.items():
                assert k != 'version'
                # TEXT affinity on the config table: values come back
                # as strings from the SQLite engine, so store strings
                configpairs.append((k, _text_affinity(v)))
        except _Incompatible:
            self._prepare_sqlite()
            self._prepared = True
            return

        lib = native_index.get_lib()
        if lib is not None:
            writer = _NativeFileWriter(lib, self.is_dbtmpfilename)
        else:
            writer = _PyFileWriter(self.is_dbtmpfilename)

        try:
            table_meta = []
            for n, cols, vals, flags in tables:
                cols_meta = []
                for name, kind, data in cols:
                    if kind == 'i64':
                        cols_meta.append({
                            'name': name, 'kind': 'i64',
                            'off': writer.block(data.tobytes())})
                    else:
                        codes, values = data
                        blobs = [_encode_text(s) for s in values]
                        offsets = np.zeros(len(blobs) + 1,
                                           dtype=np.uint32)
                        if blobs:
                            offsets[1:] = np.cumsum(
                                np.fromiter((len(x) for x in blobs),
                                            dtype=np.uint32,
                                            count=len(blobs)))
                        cols_meta.append({
                            'name': name, 'kind': 'str',
                            'ndict': len(blobs),
                            'codes_off': writer.block(codes.tobytes()),
                            'doff_off': writer.block(offsets.tobytes()),
                            'dbytes_off': writer.block(b''.join(blobs)),
                            'dbytes_len': int(offsets[-1]),
                        })
                table_meta.append({
                    'nrows': n,
                    'columns': cols_meta,
                    'value_off': writer.block(vals.tobytes()),
                    'isint_off': writer.block(flags.tobytes()),
                })

            metrics_meta = [
                {'id': mid, 'label': label, 'filter': filt,
                 'params': params}
                for mid, label, filt, params in
                (self._catalog if self._catalog is not None
                 else metric_catalog_rows(self.is_metrics))]
            footer = json.dumps({
                'config': dict(configpairs),
                'metrics': metrics_meta,
                'tables': table_meta,
            }).encode()
            writer.finalize(footer)
            self._prepared = True
        except BaseException:
            # crash hygiene: a failed serialization must not leave
            # the tmp file behind
            writer.discard()
            self._discard_tmp()
            raise

    def commit(self, discard_on_error=True):
        """Phase 2: atomically rename the prepared tmp into place
        (see index_sink.IndexSink.commit for both contracts)."""
        from . import faults as mod_faults
        if self._delegate is not None:
            self._delegate.commit(discard_on_error=discard_on_error)
            return
        try:
            # flip_path: corrupt the tmp AFTER its checksum landed in
            # the commit record — the injected post-publish rot the
            # integrity catalog exists to catch (torn stays unarmed
            # here: a torn tmp would be rolled forward as-is)
            mod_faults.fire('sink.rename',
                            flip_path=self.is_dbtmpfilename)
            os.rename(self.is_dbtmpfilename, self.is_dbfilename)
        except BaseException:
            if discard_on_error:
                self._discard_tmp()
            raise

    def flush(self):
        if not self._prepared:
            self.prepare()
        self.commit()

    def abort(self):
        """Discard the sink: drop the buffers and best-effort unlink
        any tmp file a failed flush left mid-write."""
        self._keycols = [[[] for _ in names] for names in self._names]
        self._vals = [[] for _ in self.is_metrics]
        self._discard_tmp()

    def _discard_tmp(self):
        try:
            os.unlink(self.is_dbtmpfilename)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class DncIndexQuerier(IndexQuerierBase):
    """Drop-in for index_query.IndexQuerier over a DNC file."""

    def __init__(self, filename):
        self.qi_dbfilename = filename
        self._lib = native_index.get_lib()
        self._h = None
        self._mm = None
        self._file = None
        if self._lib is not None:
            self._h = self._lib.dn_idx_open(filename.encode())
            if not self._h:
                raise DNError('index "%s": cannot open' % filename)
            import ctypes
            size = self._lib.dn_idx_size(self._h)
            base = self._lib.dn_idx_base(self._h)
            self._buf = np.ctypeslib.as_array(
                ctypes.cast(base, ctypes.POINTER(ctypes.c_uint8)),
                shape=(size,))
            foff = self._lib.dn_idx_footer_off(self._h)
            flen = self._lib.dn_idx_footer_len(self._h)
        else:
            self._file = open(filename, 'rb')
            self._mm = mmap.mmap(self._file.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._buf = np.frombuffer(self._mm, dtype=np.uint8)
            head = bytes(self._buf[:native_index.HEADER_SIZE].tobytes())
            if len(head) < native_index.HEADER_SIZE:
                self.close()
                raise DNError('index "%s": bad header' % filename)
            fmtver, = struct.unpack('<I', head[8:12])
            foff, flen = struct.unpack('<qq', head[16:32])
            if head[:8] != native_index.MAGIC or \
                    fmtver != native_index.FORMAT_VERSION or \
                    foff < native_index.HEADER_SIZE or flen < 0 or \
                    foff + flen > len(self._buf):
                self.close()
                raise DNError('index "%s": bad header' % filename)

        try:
            footer = json.loads(
                self._buf[foff:foff + flen].tobytes().decode())
            self.qi_config = footer['config']
            self._check_version()
            self.qi_metrics = []
            for mm_ in footer['metrics']:
                self._add_metric(mm_['id'], mm_['label'],
                                 mm_['filter'], mm_['params'])
            self._tables = footer['tables']
            self._validate_tables()
        except DNError:
            self.close()
            raise
        except (ValueError, UnicodeDecodeError, KeyError,
                TypeError) as e:
            self.close()
            raise DNError('index "%s": bad footer' % filename,
                          cause=DNError(repr(e)))

    def _validate_tables(self):
        """Malformed descriptors must fail at open with DNError, not
        KeyError/ValueError mid-query (the SQLite engine likewise
        reports corrupt databases at open)."""
        if not isinstance(self._tables, list):
            raise ValueError('"tables" is not a list')
        for t in self._tables:
            if not (isinstance(t, dict)
                    and isinstance(t.get('nrows'), int)
                    and t['nrows'] >= 0
                    and isinstance(t.get('columns'), list)
                    and isinstance(t.get('value_off'), int)
                    and isinstance(t.get('isint_off'), int)):
                raise ValueError('bad table descriptor')
            for c in t['columns']:
                if not (isinstance(c, dict)
                        and isinstance(c.get('name'), str)):
                    raise ValueError('bad column descriptor')
                if c.get('kind') == 'i64':
                    ok = isinstance(c.get('off'), int)
                elif c.get('kind') == 'str':
                    ok = all(isinstance(c.get(k), int) for k in
                             ('ndict', 'codes_off', 'doff_off',
                              'dbytes_off', 'dbytes_len'))
                else:
                    ok = False
                if not ok:
                    raise ValueError('bad column descriptor')

    def close(self):
        if self._h is not None:
            self._lib.dn_idx_close(self._h)
            self._h = None
        self._buf = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- column access (zero-copy views over the mapped file) -------------

    def _view(self, off, count, dtype):
        if not count:
            return np.zeros(0, dtype=dtype)
        nbytes = count * np.dtype(dtype).itemsize
        if not (isinstance(off, int) and 0 <= off
                and off + nbytes <= len(self._buf)):
            raise DNError('index "%s": block out of range'
                          % self.qi_dbfilename)
        return np.frombuffer(self._buf, dtype=dtype, count=count,
                             offset=off)

    def _table(self, table_ref):
        mid = table_ref['metric_id']
        if not (0 <= mid < len(self._tables)):
            raise DNError('executing query: no such table "%s"'
                          % table_ref['table'])
        return self._tables[mid]

    def _column(self, t, name):
        for c in t['columns']:
            if c['name'] == name:
                return c
        raise DNError('executing query: no such column "%s"' % name)

    def _codes(self, c, t):
        """The column's code array, range-checked once against the
        dictionary size (corrupt files must fail with DNError, not
        IndexError mid-query)."""
        codes = self._view(c['codes_off'], t['nrows'], np.int32)
        if not c.get('_codes_ok'):
            if len(codes) and (int(codes.max()) >= c['ndict']
                               or int(codes.min()) < -1):
                raise DNError('index "%s": dictionary code out of '
                              'range' % self.qi_dbfilename)
            c['_codes_ok'] = True
        return codes

    def _dict_entries(self, c):
        """The column's dictionary as utf-8 bytes objects."""
        cached = c.get('_dict')
        if cached is None:
            nd = c['ndict']
            offs = self._view(c['doff_off'], nd + 1, np.uint32)
            blob = self._buf[c['dbytes_off']:
                             c['dbytes_off'] + c['dbytes_len']].tobytes()
            cached = [blob[offs[i]:offs[i + 1]] for i in range(nd)]
            c['_dict'] = cached
        return cached

    # -- predicate -> vectorized mask --------------------------------------

    def _eval_mask(self, filt, t, n):
        if not filt:
            return np.ones(n, dtype=bool)
        if 'and' in filt:
            out = np.ones(n, dtype=bool)
            for sub in filt['and']:
                out &= self._eval_mask(sub, t, n)
            return out
        if 'or' in filt:
            out = np.zeros(n, dtype=bool)
            for sub in filt['or']:
                out |= self._eval_mask(sub, t, n)
            return out
        op = next(iter(filt))
        name, const = filt[op]
        c = self._column(t, name)
        if c['kind'] == 'i64':
            return self._mask_i64(c, t, op, const, n)
        return self._mask_str(c, t, op, const, n)

    @staticmethod
    def _cmp(op, a, b):
        if op == 'eq':
            return a == b
        if op == 'ne':
            return a != b
        if op == 'lt':
            return a < b
        if op == 'le':
            return a <= b
        if op == 'gt':
            return a > b
        return a >= b

    def _mask_i64(self, c, t, op, const, n):
        arr = self._view(c['off'], t['nrows'], np.int64)
        if isinstance(const, str):
            num = _sqlite_text_to_num(const)
            if num is None:
                # INTEGER storage sorts before TEXT in SQLite
                if op in ('lt', 'le', 'ne'):
                    return np.ones(n, dtype=bool)
                return np.zeros(n, dtype=bool)
            const = num
        if isinstance(const, bool):
            const = int(const)
        if not isinstance(const, (int, float)):
            return np.zeros(n, dtype=bool)
        if isinstance(const, float):
            return self._mask_i64_float(arr, op, const, n)
        if const > 2 ** 63 - 1:
            return self._all_if(op in ('lt', 'le', 'ne'), n)
        if const < -2 ** 63:
            return self._all_if(op in ('gt', 'ge', 'ne'), n)
        return self._cmp(op, arr, np.int64(const))

    @staticmethod
    def _all_if(cond, n):
        return np.ones(n, dtype=bool) if cond else np.zeros(n, dtype=bool)

    def _mask_i64_float(self, arr, op, const, n):
        """Exact INTEGER-vs-REAL comparison.  SQLite compares the two
        types exactly (sqlite3IntFloatCompare); numpy's implicit int64 ->
        float64 promotion rounds values with |v| > 2^53, so integral
        REALs compare as exact ints and non-integral REALs split into
        floor/ceil integer comparisons."""
        import math
        if math.isnan(const):
            # SQLite stores NaN as NULL, and NULL comparisons match no
            # rows whatever the operator.  (Defensive only: json_parse
            # and krill reject non-finite constants upstream.)
            return np.zeros(n, dtype=bool)
        if math.isinf(const):
            if const > 0:
                return self._all_if(op in ('lt', 'le', 'ne'), n)
            return self._all_if(op in ('gt', 'ge', 'ne'), n)
        if const.is_integer():
            ci = int(const)
            if ci > 2 ** 63 - 1:
                return self._all_if(op in ('lt', 'le', 'ne'), n)
            if ci < -2 ** 63:
                return self._all_if(op in ('gt', 'ge', 'ne'), n)
            return self._cmp(op, arr, np.int64(ci))
        if op == 'eq':
            return np.zeros(n, dtype=bool)
        if op == 'ne':
            return np.ones(n, dtype=bool)
        f = math.floor(const)  # v < const <=> v <= floor(const)
        if f >= 2 ** 63 - 1:
            return self._all_if(op in ('lt', 'le'), n)
        if f < -2 ** 63:
            return self._all_if(op in ('gt', 'ge'), n)
        if op in ('lt', 'le'):
            return arr <= np.int64(f)
        return arr >= np.int64(f + 1)

    def _mask_str(self, c, t, op, const, n):
        codes = self._codes(c, t)
        # TEXT affinity applied to the non-text operand
        if isinstance(const, bool):
            const = '1' if const else '0'
        elif isinstance(const, int):
            const = str(const)
        elif isinstance(const, float):
            const = _sqlite_real_text(const)
        cb = _encode_text(const)
        entries = self._dict_entries(c)
        table = np.fromiter((self._cmp(op, e, cb) for e in entries),
                            dtype=bool, count=len(entries))
        # NULL compares as NULL -> excluded, whatever the operator
        table = np.concatenate([table, [False]])
        return table[np.where(codes >= 0, codes, len(entries))]

    # -- GROUP BY / SUM ----------------------------------------------------

    def _grouped(self, table_ref, filt, groupby):
        """Masked GROUP BY/SUM over the mapped columns: returns
        (decoders, key_columns_as_lists, sums_list, isint_list)."""
        t = self._table(table_ref)
        n = t['nrows']
        mask = self._eval_mask(filt, t, n)
        values = self._view(t['value_off'], n, np.float64)
        isint = self._view(t['isint_off'], n, np.uint8)

        keycols = []
        decoders = []
        for name in groupby:
            c = self._column(t, name)
            if c['kind'] == 'i64':
                keycols.append(self._view(c['off'], n, np.int64))
                decoders.append(None)
            else:
                codes = self._codes(c, t)
                entries = self._dict_entries(c)
                order = sorted(range(len(entries)),
                               key=lambda i: entries[i])
                rank = np.empty(len(entries) + 1, dtype=np.int64)
                for r, i in enumerate(order):
                    rank[i] = r
                rank[-1] = -1  # NULL sorts first, like SQLite
                keycols.append(rank[np.where(codes >= 0, codes,
                                             len(entries))])
                strings = self._dict_strings(c, entries)
                decoders.append([strings[i] for i in order])

        res = native_index.groupby_native(keycols, values, isint, mask) \
            if n else ([np.zeros(0, np.int64) for _ in keycols],
                       np.zeros(0), np.zeros(0, np.uint8))
        if res is None:
            res = _groupby_numpy(keycols, values, isint, mask)
        out_keys, sums, flags = res
        # bulk-convert to Python scalars once (tolist) instead of one
        # numpy-scalar __int__/__float__ per emitted cell
        return (decoders,
                [np.asarray(k, dtype=np.int64).tolist()
                 for k in out_keys],
                np.asarray(sums, dtype=np.float64).tolist(),
                np.asarray(flags).tolist())

    def stack_blocks(self, table_ref, filt, groupby):
        """Columnar block export for the stacked cross-shard path
        (index_query_stack): evaluate the pushdown filter as a
        vectorized mask and hand back the matching rows' raw columns —
        no per-shard group-by; grouping happens once, across every
        shard.  Returns (nrows, cols, values f64, isint u8) where each
        groupby column is ('i64', int64 array) or ('dict', int64 codes
        with -1 for NULL, dictionary entries as bytes, decoded
        strings).  The selected arrays are copies (fancy indexing) and
        the dictionary lists are immutable-object refs, so blocks stay
        valid after the shard handle is checked back in (and possibly
        evicted/closed) — required for the pool-loaded stacking."""
        t = self._table(table_ref)
        n = t['nrows']
        mask = self._eval_mask(filt, t, n)
        sel = np.nonzero(mask)[0]
        cols = []
        for name in groupby:
            c = self._column(t, name)
            if c['kind'] == 'i64':
                cols.append(
                    ('i64', self._view(c['off'], n, np.int64)[sel]))
            else:
                codes = self._codes(c, t)[sel].astype(np.int64)
                entries = self._dict_entries(c)
                cols.append(('dict', codes, entries,
                             self._dict_strings(c, entries)))
        values = self._view(t['value_off'], n, np.float64)[sel]
        isint = self._view(t['isint_off'], n, np.uint8)[sel]
        return (len(sel), cols, values, isint)

    def _execute(self, table_ref, filt, groupby):
        decoders, out_keys, sums, flags = self._grouped(
            table_ref, filt, groupby)
        ngroups = len(sums)

        if not groupby and ngroups == 0:
            # SELECT SUM(value) with no GROUP BY: one row, NULL sum
            yield {'value': None}
            return

        for g in range(ngroups):
            rd = {}
            for k, name in enumerate(groupby):
                kv = out_keys[k][g]
                dec = decoders[k]
                if dec is None:
                    rd[name] = kv
                else:
                    rd[name] = None if kv < 0 else dec[kv]
            s = sums[g]
            rd['value'] = int(s) if flags[g] else s
            yield rd

    def _execute_keys(self, table_ref, filt, groupby, query, aggr):
        """The serving-path fast lane: grouped rows become write_key()
        tuples directly — no row dicts, no pluck, no re-coercion of
        values Aggregator.write would just round-trip.  Engaged only
        when the mapping is provably 1:1 with the row path: every
        breakdown selects its own column (field == name, so the
        groupby projection covers every breakdown in order) and the
        target aggregator has no stage (its write() would bump
        per-record counters write_key() does not)."""
        if aggr.stage is not None:
            return False
        bds = query.qc_breakdowns
        if len(groupby) != len(bds):
            return False
        for b in bds:
            if b.get('field', b['name']) != b['name']:
                return False

        decoders, out_keys, sums, flags = self._grouped(
            table_ref, filt, groupby)
        ngroups = len(sums)

        if not groupby:
            # SELECT SUM(value) with no GROUP BY: one row, NULL -> 0
            if ngroups == 0:
                aggr.write_key((), 0)
            else:
                s = sums[0]
                aggr.write_key((), int(s) if flags[0] else s)
            return True

        from .aggr import coerce_bucket_value
        jsv_to_string = jsv.to_string
        bucketizers = [query.qc_bucketizers.get(b['name']) for b in bds]
        nkeys = len(groupby)
        for g in range(ngroups):
            keys = []
            dropped = False
            for k in range(nkeys):
                kv = out_keys[k][g]
                dec = decoders[k]
                v = kv if dec is None else \
                    (None if kv < 0 else dec[kv])
                bk = bucketizers[k]
                if bk is None:
                    # to_string returns str operands verbatim; skip
                    # its type dispatch for the common decoded case
                    keys.append(v if type(v) is str
                                else jsv_to_string(v))
                    continue
                v = coerce_bucket_value(v)
                if v is None:
                    dropped = True
                    break
                keys.append(bk.bucketize(v))
            if dropped:
                continue
            s = sums[g]
            aggr.write_key(tuple(keys), int(s) if flags[g] else s)
        return True

    def metric_rows(self, mi, names):
        """The append-merge read seam (`dn follow`), DNC engine: metric
        `mi`'s raw stored rows in append order — i64 columns decode to
        Python ints, dictionary columns to their stored strings (NULL
        codes to None), the value column to int when its isint flag is
        set — exactly the values the writer buffered, so re-writing
        them reproduces the same typed columns."""
        if not (0 <= mi < len(self._tables)):
            raise DNError('executing query: no such table '
                          '"dragnet_index_%s"' % mi)
        t = self._tables[mi]
        n = t['nrows']
        out_cols = []
        for name in names:
            c = self._column(t, sqlite3_escape(name))
            if c['kind'] == 'i64':
                out_cols.append(
                    self._view(c['off'], n, np.int64).tolist())
            else:
                strings = self._dict_strings(c, self._dict_entries(c))
                out_cols.append(
                    [None if k < 0 else strings[k]
                     for k in self._codes(c, t).tolist()])
        values = self._view(t['value_off'], n, np.float64).tolist()
        isint = self._view(t['isint_off'], n, np.uint8).tolist()
        vals = [int(v) if f else v for v, f in zip(values, isint)]
        if not out_cols:
            return [(v,) for v in vals]
        return list(zip(*(out_cols + [vals])))

    def _dict_strings(self, c, entries):
        cached = c.get('_strings')
        if cached is None:
            cached = []
            for raw in entries:
                try:
                    cached.append(raw.decode('utf-8', 'surrogatepass'))
                except UnicodeDecodeError:
                    cached.append(raw.decode('utf-8', 'surrogateescape'))
            c['_strings'] = cached
        return cached


def _groupby_numpy(keycols, values, isint, mask):
    """numpy fallback with the same contract as the C++ kernel."""
    sel = np.nonzero(mask)[0]
    nkeys = len(keycols)
    if nkeys == 0:
        if len(sel) == 0:
            return ([], np.zeros(0), np.zeros(0, np.uint8))
        return ([], np.array([float(values[sel].sum())]),
                np.array([int(isint[sel].min())], dtype=np.uint8))
    if len(sel) == 0:
        return ([np.zeros(0, np.int64) for _ in keycols],
                np.zeros(0), np.zeros(0, np.uint8))
    keys = np.stack([np.asarray(k, dtype=np.int64)[sel]
                     for k in keycols])
    order = np.lexsort(keys[::-1])
    keys = keys[:, order]
    vals = values[sel][order]
    flags = isint[sel][order]
    boundary = np.empty(keys.shape[1], dtype=bool)
    boundary[0] = True
    boundary[1:] = (keys[:, 1:] != keys[:, :-1]).any(axis=0)
    starts = np.nonzero(boundary)[0]
    sums = np.add.reduceat(vals, starts)
    gflags = np.minimum.reduceat(flags, starts)
    return ([keys[k][starts] for k in range(nkeys)], sums, gflags)
