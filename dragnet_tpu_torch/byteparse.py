"""Projected-field ingest straight from raw newline-JSON bytes.

Counterpart of dragnet_tpu/byteparse.py, whole, with two changes: the
device lane's structural kernel is the port's (ByteParser(device=) takes
the torch device it runs on; ops/byteparse_kernels.py, CUDA C++ on the
card), and a forced device lane never turns into the vector lane when
its kernel is unavailable (choose_lane): the first parity call on the
device raises DNError instead.  The reference's text follows.

The reference's dense `dn scan` profile is a CPU JSON parser with an
accelerator attached: ~55% of its wall time went to the per-line parse
on its TPU rig (docs/performance.md),
which walks every byte with data-dependent control flow.  This module
replaces that walk, for the lines it can prove simple, with a
*vectorized byte-stream program*: the read chunk becomes a uint8
array; the string-parity scan (ops/byteparse_kernels.py, bit-packed —
the one sequential dependency, and the piece the device lane stages
on the card) plus elementwise byte classes yield a token stream;
bracket depth is a prefix sum over the ~6x smaller bracket
subsequence; a 512-entry pair table validates each line's token
grammar; and typed extraction lanes decode exactly the fields the
query projects — integer/float spans with an exact power-of-ten fast
path, known-dictionary strings interned per *unique* span, timestamps
through a vectorized ISO-8601 parse.  Per-record Python work is gone
from the fast path entirely.

Semantics are byte-identical to the reference parse BY CONSTRUCTION,
not by reimplementation effort: any line the fast path cannot prove it
handles exactly — escapes, non-ASCII bytes, control characters,
whitespace outside strings, duplicate projected keys, projected values
nested beyond the flat projection, a span the typed lanes can't
decode, or any token-grammar doubt — is routed through the existing
host parser (`json.loads` + flat pluck), the same code the per-record
ingest path runs.  The fast path only ever accepts lines where both
parsers provably agree; everything else falls back per line, counted.

Three lanes, selected by ``DN_PARSE`` / ``dn scan --parse``:

* ``host``   — the existing ingest (native C++ parser when built,
  per-record Python otherwise),
* ``vector`` — this parser with the numpy structural kernel,
* ``device`` — this parser with the structural pass staged on the
  torch device (raw bytes upload; the quote-parity kernel, bit-identical
  outputs, deadline-armored first contact that raises on a fault),
* ``auto``   — the native parser when available (the established fast
  lane), the vector lane when the native toolchain is absent and the
  query is eligible.

Eligibility is per query: json format and flat field paths (dotted
paths engage jsprim-pluck priority rules the byte matcher does not
implement — those scans keep the host lane, with a counter, never an
error).

ByteParser implements the NativeParser provider interface (columns /
date_columns / dictionary / counters / batch_size / reset_batch plus
the device-path stats accessors), so the vectorized engine, the
DN_SCAN_THREADS executor (scan_mt.ParserSnapshot) and the device scan
consume it unchanged.
"""

import json
import os
import time

import numpy as np

from . import jsvalues as jsv
from .native import (TAG_NULL, TAG_FALSE, TAG_TRUE, TAG_NUMBER,
                     TAG_INT, TAG_STRING, TAG_OBJECT, TAG_ARRAY)
from .ops import byteparse_kernels as bk

DATE_OK, DATE_UNDEF, DATE_BAD = 0, 1, 2

# token classes (3 bits; _TCLASS maps a token's first byte — quote ->
# STR, structural chars -> themselves, any other byte can only start a
# primitive run)
C_OPEN_O, C_CLOSE_O, C_OPEN_A, C_CLOSE_A = 0, 1, 2, 3
C_COMMA, C_COLON, C_STR, C_PRIM = 4, 5, 6, 7
_TCLASS = np.full(256, C_PRIM, dtype=np.int16)
_TCLASS[ord('{')] = C_OPEN_O
_TCLASS[ord('}')] = C_CLOSE_O
_TCLASS[ord('[')] = C_OPEN_A
_TCLASS[ord(']')] = C_CLOSE_A
_TCLASS[ord(',')] = C_COMMA
_TCLASS[ord(':')] = C_COLON
_TCLASS[ord('"')] = C_STR


def _build_pair_table():
    """Adjacent-token grammar as one 512-entry lookup:
    key = aclass<<6 | a_is_key<<5 | bclass<<2 | boundary_ctx
    (ctx: 0 top, 1 object, 2 array).  True = the pair is legal."""
    tab = np.zeros(512, dtype=bool)
    vstart = (C_STR, C_PRIM, C_OPEN_O, C_OPEN_A)
    for a in range(8):
        for akey in (0, 1):
            for b in range(8):
                for ctx in (0, 1, 2):
                    if a == C_OPEN_O:
                        ok = b in (C_STR, C_CLOSE_O)
                    elif a == C_OPEN_A:
                        ok = b in vstart or b == C_CLOSE_A
                    elif a == C_COLON:
                        ok = b in vstart
                    elif a == C_COMMA:
                        ok = (b == C_STR) if ctx == 1 else \
                            (b in vstart if ctx == 2 else False)
                    elif a == C_STR and akey:
                        ok = b == C_COLON
                    else:
                        # value end: PRIM, CLOSE_*, or a value STR
                        ok = (b in (C_COMMA, C_CLOSE_O)) if ctx == 1 \
                            else (b in (C_COMMA, C_CLOSE_A)
                                  if ctx == 2 else False)
                    tab[(a << 6) | (akey << 5) | (b << 2) | ctx] = ok
    return tab


_PAIR_OK = _build_pair_table()

# structural limits of the fast path; beyond them a line falls back
MAX_DEPTH = 16
MAX_NUM_LEN = 40
# padded-matrix interning budget (bytes) before the per-span loop
INTERN_MATRIX_BUDGET = 64 << 20

# ---------------------------------------------------------------------------
# Lane selection
# ---------------------------------------------------------------------------

def parse_mode():
    """DN_PARSE: auto | host | vector | device (unknown values read as
    auto, matching the other engine knobs' forgiving parses)."""
    v = os.environ.get('DN_PARSE', 'auto')
    return v if v in ('auto', 'host', 'vector', 'device') else 'auto'


class LaneChoice(object):
    __slots__ = ('lane', 'reason')

    def __init__(self, lane, reason):
        self.lane = lane            # 'host' | 'vector' | 'device'
        self.reason = reason

    @property
    def engaged(self):
        return self.lane != 'host'


def _filter_fields(ast, out):
    if not ast:
        return
    op = next(iter(ast))
    if op in ('and', 'or'):
        for sub in ast[op]:
            _filter_fields(sub, out)
    else:
        out.add(ast[op][0])


def query_fields(queries, time_field, ds_filter):
    """Every raw-record field path the scan set reads (the projection
    the parser must extract): filter leaves, breakdown sources,
    synthetic date sources, and the time field when bounds apply."""
    fields = set()
    _filter_fields(ds_filter, fields)
    for q in queries:
        _filter_fields(q.qc_filter, fields)
        for s in q.qc_synthetic:
            fields.add(s['field'])
        for b in q.qc_breakdowns:
            if not any(s['name'] == b['name'] for s in q.qc_synthetic):
                fields.add(b['name'])
        if (q.qc_before is not None or q.qc_after is not None) and \
                isinstance(time_field, str):
            fields.add(time_field)
    return fields


def choose_lane(queries, time_field, ds_filter, fmt,
                native_available):
    """Pick the ingest lane for a scan/build.  Ineligible projections
    under a forced vector/device mode fall back to the host lane with
    a reason (surfaced as a counter), never an error.  An eligible
    forced device lane stays the device lane: whether its kernel runs
    shows at its first call, which raises if it cannot."""
    mode = parse_mode()
    fields = query_fields(queries, time_field, ds_filter)
    if fmt != 'json':
        eligible, why = False, 'format "%s"' % fmt
    else:
        dotted = sorted(f for f in fields if '.' in f)
        eligible = not dotted
        why = 'dotted path "%s"' % dotted[0] if dotted else ''
    if mode == 'host':
        return LaneChoice('host', 'forced host')
    if mode in ('vector', 'device'):
        if not eligible:
            return LaneChoice('host', 'projection ineligible: ' + why)
        return LaneChoice(mode, 'forced ' + mode)
    # auto: the native C parser is the established fast lane; the byte
    # lane steps in when the toolchain is absent and the query allows
    if native_available:
        return LaneChoice('host', 'auto: native parser')
    if eligible:
        return LaneChoice('vector', 'auto: native parser unavailable')
    return LaneChoice('host', 'auto: ' + why)


def note_ineligible(stage, lane):
    """A requested vector/device lane that could not engage bumps a
    hidden counter on the parse stage — acceptance contract: fall back
    with a counter, not an error."""
    if parse_mode() in ('vector', 'device') and not lane.engaged:
        stage.bump_hidden('parse lane ineligible', 1)


def publish_counters(stage, parser):
    """Assign the lane's monotonic telemetry totals onto the parse
    stage as hidden counters (DN_COUNTERS_ALL=1 surfaces them, same
    contract as the index shard-pruning counters)."""
    lc = getattr(parser, 'lane_counters', None)
    if lc is None:
        return
    for name, value in lc().items():
        if value:
            stage.hidden.add(name)
            stage.counters[name] = value
    # observability: the lane's accumulated parse wall time becomes
    # one synthesized `byteparse` span (per-buffer spans would swamp
    # the tree) plus an always-on stage histogram entry
    seconds = getattr(parser, 'parse_seconds', None)
    if seconds:
        from .obs import metrics as obs_metrics
        from .obs import trace as obs_trace
        ms = seconds * 1000.0
        obs_metrics.observe('stage_ms', ms, stage='byteparse')
        obs_trace.add_span('byteparse', ms,
                           lines=parser.nlines,
                           fallback_lines=parser.lines_fb)


# ---------------------------------------------------------------------------
# Vectorized number grammar + decode (strict JSON numbers)
# ---------------------------------------------------------------------------

_POW10 = 10.0 ** np.arange(19)


def decode_numbers(mat, lens):
    """Validate/decode JSON number spans from a padded byte matrix.

    Two lanes.  Plain integers (the overwhelming majority in machine
    logs) validate and decode in ~10 vector ops: a digit-count check
    plus an exact power-of-ten dot product for spans of <= 15 digits
    (every partial term and sum below 2^53 — bit-equal to strtod).
    Everything else drops to the positional validator
    (_decode_general) on the leftover subset: first-dot /
    first-exponent columns + digit-run checks, equivalent to the
    strict JSON number grammar.  Valid spans outside the exact decode
    regime are marked `slow`; the caller resolves those (rare, usually
    uncaptured) spans with float(span), which IS strtod.

    Returns (accept, value, is_int, slow, integral)."""
    nrows, ncols = mat.shape
    col = np.arange(ncols)
    inspan = col < lens[:, None]
    dig = (mat >= 48) & (mat <= 57) & inspan
    neg = mat[:, 0] == 45
    nd = dig.sum(axis=1)
    body = lens - neg
    simple = (nd == body) & (nd >= 1)
    first = mat[np.arange(nrows),
                np.minimum(neg.astype(np.int64), ncols - 1)]
    simple &= (first != 48) | (nd == 1)
    exact = simple & (nd <= 15)
    w = _POW10[np.clip(lens[:, None] - 1 - col, 0, 18)]
    value = (np.where(dig, mat - np.uint8(48), 0) * w).sum(axis=1)
    value = np.where(neg, -value, value)
    value = np.where(exact, value, 0.0)
    accept = simple
    is_int = exact & (np.abs(value) <= 2.0 ** 53)
    slow = simple & ~exact
    integral = simple.copy()
    rest = np.flatnonzero(~simple)
    if len(rest):
        r_acc, r_slow, r_int = _decode_general(mat[rest], lens[rest])
        accept[rest] = r_acc
        slow[rest] = r_slow
        integral[rest] = r_int
    return accept, value, is_int, slow, integral


def _decode_general(mat, lens):
    """Positional JSON-number grammar over the non-plain-integer
    subset; every valid row here is `slow` (resolved via float(span)).
    Returns (accept, slow, integral)."""
    nrows, ncols = mat.shape
    col = np.arange(ncols)
    inspan = col < lens[:, None]
    dig = (mat >= 48) & (mat <= 57) & inspan
    c_dot = (mat == 46) & inspan
    c_e = ((mat == 101) | (mat == 69)) & inspan
    c_minus = (mat == 45) & inspan
    c_plus = (mat == 43) & inspan
    other = inspan & ~(dig | c_dot | c_e | c_minus | c_plus)

    neg = c_minus[:, 0]
    istart = neg.astype(np.int64)           # first mantissa column
    # first '.' / 'e' columns (ncols when absent)
    dotcol = np.where(c_dot.any(axis=1), np.argmax(c_dot, axis=1),
                      ncols)
    ecol = np.where(c_e.any(axis=1), np.argmax(c_e, axis=1), ncols)
    integral = (dotcol == ncols) & (ecol == ncols)
    # integer-part end: min(dotcol, ecol, len)
    iend = np.minimum(np.minimum(dotcol, ecol), lens)
    # digit run [istart, iend): all digits, non-empty
    int_digits = (dig & (col >= istart[:, None]) &
                  (col < iend[:, None])).sum(axis=1)
    ok = (int_digits == iend - istart) & (int_digits >= 1)
    # no leading zero unless the integer part IS "0"
    first = mat[np.arange(nrows), np.minimum(istart, ncols - 1)]
    ok &= (first != 48) | (int_digits == 1)
    # at most one dot, before the exponent, with >= 1 digit run after
    ok &= c_dot.sum(axis=1) <= 1
    has_dot = dotcol < ncols
    fend = np.minimum(ecol, lens)
    frac_digits = (dig & (col > dotcol[:, None]) &
                   (col < fend[:, None])).sum(axis=1)
    ok &= ~has_dot | ((dotcol < fend) &
                      (frac_digits == fend - dotcol - 1) &
                      (frac_digits >= 1))
    # exponent: optional sign then >= 1 digits to end of span
    ok &= c_e.sum(axis=1) <= 1
    has_e = ecol < ncols
    esign = np.take_along_axis(
        c_minus | c_plus,
        np.minimum(ecol + 1, ncols - 1)[:, None], axis=1)[:, 0]
    esign = esign & has_e
    dstart = ecol + 1 + esign
    exp_digits = (dig & (col >= dstart[:, None])).sum(axis=1)
    ok &= ~has_e | ((exp_digits >= 1) &
                    (exp_digits == lens - dstart))
    # stray characters: '-' only at col 0 / exponent sign, '+' only as
    # exponent sign, nothing else at all
    ok &= ~other.any(axis=1)
    nsign = neg.astype(np.int64) + esign
    ok &= (c_minus | c_plus).sum(axis=1) == nsign
    # plain integers never reach this lane (the simple lane covers
    # them all), so every accepted row decodes via float(span)
    return ok, ok.copy(), integral


# ---------------------------------------------------------------------------
# Vectorized ISO-8601 date parse (the two fixed machine shapes; all
# other spans take the jsvalues.date_parse path per unique value)
# ---------------------------------------------------------------------------

_MDAYS = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                  dtype=np.int64)


def _civil_days(y, m, d):
    """Hinnant days-from-civil, vectorized (int64 epoch days)."""
    y = y - (m <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    doy = (153 * (m + np.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def parse_date_spans(mat, lens):
    """(secs f64, err u8, need_python bool) for string date spans in a
    padded byte matrix.  Shapes handled vectorized:
    YYYY-MM-DDTHH:MM:SSZ (20) and YYYY-MM-DDTHH:MM:SS.mmmZ (24); any
    other span is deferred to jsvalues.date_parse (need_python) so
    semantics stay exactly the host path's."""
    nrows, ncols = mat.shape
    secs = np.zeros(nrows, dtype=np.float64)
    err = np.full(nrows, DATE_BAD, dtype=np.uint8)
    if ncols < 20:
        return secs, err, np.ones(nrows, dtype=bool)

    def dig(c):
        return (mat[:, c] >= 48) & (mat[:, c] <= 57)

    def val(c):
        return mat[:, c].astype(np.int64) - 48

    digit_cols = [0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18]
    base = np.ones(nrows, dtype=bool)
    for c in digit_cols:
        base &= dig(c)
    base &= (mat[:, 4] == 45) & (mat[:, 7] == 45) & \
        (mat[:, 10] == 84) & (mat[:, 13] == 58) & (mat[:, 16] == 58)
    shape_a = base & (lens == 20) & (mat[:, 19] == 90)
    if ncols >= 24:
        shape_b = base & (lens == 24) & (mat[:, 19] == 46) & \
            dig(20) & dig(21) & dig(22) & (mat[:, 23] == 90)
    else:
        shape_b = np.zeros(nrows, dtype=bool)
    shaped = shape_a | shape_b
    need_python = ~shaped
    if not shaped.any():
        return secs, err, need_python

    year = val(0) * 1000 + val(1) * 100 + val(2) * 10 + val(3)
    month = val(5) * 10 + val(6)
    day = val(8) * 10 + val(9)
    hh = val(11) * 10 + val(12)
    mm = val(14) * 10 + val(15)
    ss = val(17) * 10 + val(18)
    msec = np.zeros(nrows, dtype=np.int64)
    if shape_b.any():
        msec = np.where(shape_b,
                        val(20) * 100 + val(21) * 10 + val(22), 0)
    leap = (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
    okm = (month >= 1) & (month <= 12)
    maxday = _MDAYS[np.where(okm, month, 1)] + \
        (leap & (month == 2)).astype(np.int64)
    # datetime (the host reference) accepts years 1..9999 only
    ok = shaped & okm & (year >= 1) & (day >= 1) & (day <= maxday) & \
        (hh <= 23) & (mm <= 59) & (ss <= 59)
    if ok.any():
        days = _civil_days(year, month, day)
        ms = (((days * 24 + hh) * 60 + mm) * 60 + ss) * 1000 + msec
        secs = np.where(ok, np.floor_divide(ms, 1000).astype(
            np.float64), secs)
        err = np.where(ok, np.uint8(DATE_OK), err).astype(np.uint8)
    # shaped-but-invalid rows are definitively BAD (the regex matched,
    # datetime() would raise) — no python retry needed
    return secs, err, need_python


# ---------------------------------------------------------------------------
# The parser
# ---------------------------------------------------------------------------

class _Chunk(object):
    """One parse() call's columnar output (per-field tagged arrays)."""

    __slots__ = ('n', 'cols', 'dates')

    def __init__(self, n, cols, dates):
        self.n = n
        self.cols = cols      # [(tags u8, nums f64, strcodes i32)]
        self.dates = dates    # {field_index: (secs f64, err u8)}


class ByteParser(object):
    """NativeParser-compatible projected-field parser over raw bytes.

    One instance per scan: dictionaries and the date-string memo
    persist across batches, so codes are stable and repeated
    timestamps decode once."""

    def __init__(self, paths, date_hints, need_dicts=None,
                 device=None, force_fallback=False):
        self.paths = list(paths)
        self.field_index = {p: i for i, p in enumerate(paths)}
        self.hints = [bool(h) for h in date_hints]
        if need_dicts is None:
            need_dicts = [True] * len(self.paths)
        self.want_dict = [bool(d) for d in need_dicts]
        self.nthreads = 1
        # the torch device of the device lane's parity kernel; None is
        # the vector lane (the numpy kernel)
        self.device = device
        # force_fallback routes EVERY line through the host parser
        # (json.loads + the fallback converter): the differential
        # baseline that produces the same tagged columns with
        # per-record work, used by tests and `bench.py --parse-only`
        # as the host-lane equivalent-work measurement
        self.force_fallback = bool(force_fallback)
        self._parity = bk.parity_numpy if device is None \
            else bk.device_parity(device)
        self._key_bytes = [p.encode() for p in self.paths]
        self._dicts = [[] for _ in self.paths]
        self._dict_index = [{} for _ in self.paths]
        self._date_memo = {}
        self._chunks = []
        self._batch_n = 0
        self._col_cache = {}
        self.nlines = 0
        self.nbad = 0
        self.lines_fast = 0
        self.lines_fb = 0
        self.bytes_fast = 0
        self.parse_seconds = 0.0

    # -- provider interface -------------------------------------------------

    def counters(self):
        return (self.nlines, self.nbad)

    def batch_size(self):
        return self._batch_n

    def reset_batch(self):
        self._chunks = []
        self._batch_n = 0
        self._col_cache = {}

    def lane_counters(self):
        return {
            'parse lines fast-path': self.lines_fast,
            'parse lines fallback': self.lines_fb,
            'parse bytes projected': self.bytes_fast,
        }

    def dictionary(self, field):
        return self._dicts[self.field_index[field]]

    def columns(self, field):
        """(tags u8, nums f64, strcodes i32) for the current batch.
        The chunks are immutable once built, so the per-batch concat is
        memoized (device staging reads several views per batch); the
        returned arrays stay valid after reset_batch."""
        fi = self.field_index[field]
        key = ('cols', fi)
        out = self._col_cache.get(key)
        if out is not None:
            return out
        parts = [c.cols[fi] for c in self._chunks]
        if not parts:
            out = (np.zeros(0, np.uint8), np.zeros(0, np.float64),
                   np.zeros(0, np.int32))
        elif len(parts) == 1:
            t, n, s = parts[0]
            out = (t.copy(), n.copy(), s.copy())
        else:
            out = (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]),
                   np.concatenate([p[2] for p in parts]))
        self._col_cache[key] = out
        return out

    def date_columns(self, field):
        fi = self.field_index[field]
        key = ('dates', fi)
        out = self._col_cache.get(key)
        if out is not None:
            return out
        parts = [c.dates[fi] for c in self._chunks]
        if not parts:
            out = (np.zeros(0, np.float64), np.zeros(0, np.uint8))
        elif len(parts) == 1:
            s, e = parts[0]
            out = (s.copy(), e.copy())
        else:
            out = (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))
        self._col_cache[key] = out
        return out

    def tags_col(self, field):
        return self.columns(field)[0]

    def strcodes_col(self, field):
        return self.columns(field)[2]

    def date_err(self, field):
        return self.date_columns(field)[1]

    # device-path batch statistics (same contracts as NativeParser /
    # scan_mt.ParserSnapshot)

    def field_stats(self, field):
        tags, nums, strcodes = self.columns(field)
        m = (tags == TAG_INT) | (tags == TAG_NUMBER)
        nnum = int(m.sum())
        nstr = int((tags == TAG_STRING).sum())
        narr = int((tags == TAG_ARRAY).sum())
        i32ok = True
        nmn = nmx = 0.0
        if nnum:
            nm = nums[m]
            nmn = float(nm.min())
            nmx = float(nm.max())
            i32ok = bool(np.all(np.isfinite(nm)) and
                         np.all(nm == np.floor(nm)) and
                         nmn >= -(2 ** 31) and nmx <= 2 ** 31 - 1)
        return (narr, i32ok, nmn, nmx, nnum, nstr)

    def nums_i32(self, field):
        tags, nums, _ = self.columns(field)
        m = (tags == TAG_INT) | (tags == TAG_NUMBER)
        return np.where(m, nums, 0.0).astype(np.int64).astype(np.int32)

    def date_stats(self, field):
        secs, err = self.date_columns(field)
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

    def date_i32(self, field):
        secs, err = self.date_columns(field)
        return np.where(err == 0, secs, 0.0).astype(
            np.int64).astype(np.int32)

    # -- interning ----------------------------------------------------------

    def _code(self, fi, sval):
        idx = self._dict_index[fi]
        c = idx.get(sval)
        if c is None:
            c = len(self._dicts[fi])
            idx[sval] = c
            self._dicts[fi].append(sval)
        return c

    def _intern_spans(self, fi, arr, s, lens):
        """int32 dictionary codes for byte spans, vectorized per
        unique span (padded-matrix unique): Python work scales with
        distinct values, not records."""
        n = len(s)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        maxlen = int(lens.max())
        if maxlen == 0:
            return np.full(n, self._code(fi, ''), dtype=np.int32)
        if n * maxlen > INTERN_MATRIX_BUDGET:
            ab = arr.tobytes()
            return np.array(
                [self._code(fi, ab[int(a):int(a) + int(b)].decode(
                    'ascii')) for a, b in zip(s, lens)],
                dtype=np.int32)
        pad = np.zeros(maxlen, dtype=np.uint8)
        ap = np.concatenate([arr, pad])
        mat = ap[s[:, None] + np.arange(maxlen)]
        mat = np.where(np.arange(maxlen) < lens[:, None], mat, 0)
        mat = np.ascontiguousarray(mat)
        view = mat.view(np.dtype((np.void, maxlen))).reshape(n)
        uniq, first, inv = np.unique(view, return_index=True,
                                     return_inverse=True)
        # assign new codes in record (first-occurrence) order — the
        # same append discipline as the native dictionary
        order = np.argsort(first, kind='stable')
        codes_for = np.empty(len(uniq), dtype=np.int32)
        for k in order:
            r = int(first[k])
            sval = bytes(mat[r, :int(lens[r])]).decode('ascii')
            codes_for[k] = self._code(fi, sval)
        return codes_for[inv.reshape(-1)]

    def _date_python(self, sval):
        memo = self._date_memo
        ms = memo.get(sval, -1)
        if ms == -1:
            ms = jsv.date_parse(sval)
            memo[sval] = ms
        return ms

    # -- parse --------------------------------------------------------------

    # cache-blocking: every temporary the structural passes allocate is
    # O(block), so blocks sized for L2 keep the ~20 vector passes out
    # of main memory (the reference measured ~3x on its 2-core bench
    # rig; not measured for the port)
    BLOCK = 1 << 19

    def parse(self, buf):
        """Parse a buffer of complete newline-separated lines (the
        final line may lack its newline); appends one slot per valid
        record to the current batch.  Same contract as the native
        dn_parser_parse.

        Internally the buffer splits at line boundaries into
        cache-sized independent blocks (stateless structural analysis,
        then a stateful absorb — dictionary interning, fallback lines,
        counters — strictly in block order).  A worker pool over the
        analysis stage was measured and REJECTED on the reference's
        2-core bench rig: the structural passes are
        numpy-dispatch-bound at this block size, so threads convoy on
        the GIL and lose ~30%."""
        if not isinstance(buf, bytes):
            buf = bytes(buf)
        if not buf:
            return 0
        t0 = time.perf_counter()
        try:
            block = self.BLOCK
            if len(buf) <= block + (block >> 2):
                return self._absorb_block(self._scan_block(buf))
            pieces = []
            pos = 0
            n = len(buf)
            while pos < n:
                end = min(pos + block, n)
                if end < n:
                    nl = buf.rfind(b'\n', pos, end)
                    if nl < pos:
                        nl = buf.find(b'\n', end)
                        end = n if nl == -1 else nl + 1
                    else:
                        end = nl + 1
                pieces.append(buf[pos:end])
                pos = end
            return sum(self._absorb_block(self._scan_block(p))
                       for p in pieces)
        finally:
            # one perf_counter pair per buffer (buffers are large):
            # the lane's accumulated wall time feeds the synthesized
            # `byteparse` span and stage histogram (publish_counters)
            self.parse_seconds += time.perf_counter() - t0

    def _scan_block(self, buf):
        """The stateless (thread-safe) half of block parsing: line
        split, structural analysis, grammar, captures."""
        arr = np.frombuffer(buf, dtype=np.uint8)
        n = arr.size

        nl_pos = np.flatnonzero(arr == 10)
        starts = np.concatenate([np.zeros(1, np.int64), nl_pos + 1])
        ends = np.concatenate([nl_pos, np.array([n], np.int64)])
        if starts[-1] == n:        # trailing newline: no phantom line
            starts = starts[:-1]
            ends = ends[:-1]
        nlines = len(starts)
        if nlines == 0:
            return None

        # effective line end: one trailing \r tolerated (\r\n input)
        ends_eff = ends.copy()
        nonempty = ends_eff > starts
        lastb = np.zeros(nlines, dtype=np.uint8)
        lastb[nonempty] = arr[ends_eff[nonempty] - 1]
        cr_stripped = nonempty & (lastb == 13)
        ends_eff[cr_stripped] -= 1

        if self.force_fallback:
            empty = np.zeros(0, np.int64)
            ebool = np.zeros(0, dtype=bool)
            fast_line = np.zeros(nlines, dtype=bool)
            captures = [(empty, empty)] * len(self.paths)
            tok = (empty, empty, empty, ebool, ebool, ebool, ebool,
                   empty)
            prim = self._prep_prims(arr, empty, empty, empty)
        else:
            fast_line, captures, tok, prim = self._analyze(
                arr, starts, ends, ends_eff, cr_stripped, nlines)
        return (buf, arr, starts, ends, ends_eff, nlines, fast_line,
                captures, tok, prim)

    def _absorb_block(self, scanned):
        """The stateful half: fallback lines through the host parser,
        dictionary interning, counters, chunk append — serial, in
        block order."""
        if scanned is None:
            return 0
        (buf, arr, starts, ends, ends_eff, nlines, fast_line,
         captures, tok, prim) = scanned
        self.nlines += nlines

        # -- fallback lines: the host parser decides ---------------------
        fb_idx = np.flatnonzero(~fast_line)
        records_valid = np.ones(nlines, dtype=bool)
        fb_objs = {}
        for li in fb_idx.tolist():
            line = buf[int(starts[li]):int(ends[li])]
            try:
                fb_objs[li] = json.loads(line)
            except ValueError:
                records_valid[li] = False
        nbad = int(len(fb_idx) - len(fb_objs))
        self.nbad += nbad
        self.lines_fast += int(fast_line.sum())
        self.lines_fb += int(len(fb_idx))
        self.bytes_fast += int((ends_eff - starts)[fast_line].sum())

        nvalid = int(records_valid.sum())
        row_of_line = np.cumsum(records_valid) - 1

        cols = []
        dates = {}
        for fi in range(len(self.paths)):
            tags = np.zeros(nvalid, dtype=np.uint8)
            nums = np.zeros(nvalid, dtype=np.float64)
            strc = np.full(nvalid, -1, dtype=np.int32)
            hint = self.hints[fi]
            dsecs = derr = None
            if hint:
                dsecs = np.zeros(nvalid, dtype=np.float64)
                derr = np.full(nvalid, DATE_UNDEF, dtype=np.uint8)
            self._fill_captures(fi, arr, tok, prim, captures,
                                fast_line, row_of_line,
                                tags, nums, strc, dsecs, derr)
            cols.append((tags, nums, strc))
            if hint:
                dates[fi] = (dsecs, derr)

        for li, obj in fb_objs.items():
            self._fill_fallback(int(row_of_line[li]), obj, cols, dates)

        self._chunks.append(_Chunk(nvalid, cols, dates))
        self._batch_n += nvalid
        self._col_cache = {}
        return nvalid

    # -- structural analysis -------------------------------------------------

    def _analyze(self, arr, starts, ends, ends_eff, cr_stripped,
                 nlines):
        """Line eligibility + token grammar + captures.  Returns
        (fast_line mask, captures per field, token arrays, prim
        arrays)."""
        n = arr.size
        par = self._parity(arr)          # exclusive quote parity
        is_q = arr == ord('"')
        opens_b = (arr == ord('{')) | (arr == ord('['))
        closes_b = (arr == ord('}')) | (arr == ord(']'))
        struct_b = opens_b | closes_b | (arr == ord(',')) | \
            (arr == ord(':'))
        bad_b = ((arr < 0x20) & (arr != 10)) | (arr >= 0x80) | \
            (arr == ord('\\'))
        sp_b = arr == ord(' ')

        lengths = np.diff(np.concatenate([starts,
                                          np.array([n], np.int64)]))
        line_id = np.repeat(np.arange(nlines, dtype=np.int64), lengths)
        phase = par[starts]
        phase_rep = np.repeat(phase, lengths)
        outside_b = par == phase_rep

        q_pos = np.flatnonzero(is_q)
        # even quote count per line == string parity returns to the
        # line-start phase after the line's last byte (no bincount)
        ends_m1 = np.maximum(ends - 1, 0)
        q_after = (par[ends_m1] != 0) ^ is_q[ends_m1]
        even_q = np.where(ends > starts, q_after == (phase != 0), True)
        if bad_b.any():
            nbadb = np.bincount(line_id[np.flatnonzero(bad_b)],
                                minlength=nlines)
            # the tolerated trailing \r was counted as a bad byte
            clean = nbadb == cr_stripped
        else:
            clean = np.ones(nlines, dtype=bool)

        nonempty2 = ends_eff > starts
        firstb = np.zeros(nlines, dtype=np.uint8)
        firstb[nonempty2] = arr[starts[nonempty2]]
        lastb = np.zeros(nlines, dtype=np.uint8)
        lastb[nonempty2] = arr[ends_eff[nonempty2] - 1]

        elig = ((ends_eff - starts) >= 2) & (firstb == ord('{')) & \
            (lastb == ord('}')) & clean & even_q

        # whitespace outside strings -> fallback (spaces only; tabs
        # and \r are bad bytes already)
        spo = np.flatnonzero(sp_b & outside_b)
        if len(spo):
            elig[line_id[spo]] = False

        line_bad = np.zeros(nlines, dtype=bool)

        # -- token stream (positions sorted for free: one union mask)
        opener_b = is_q & outside_b
        m_prim = outside_b & ~(is_q | struct_b | sp_b | bad_b) & \
            (arr != 10)
        pstart_m = m_prim.copy()
        pstart_m[1:] &= ~m_prim[:-1]
        pend_m = m_prim.copy()
        pend_m[:-1] &= ~m_prim[1:]
        p_end = np.flatnonzero(pend_m) + 1

        tok_mask = (struct_b & outside_b) | opener_b | pstart_m
        tok_pos = np.flatnonzero(tok_mask)
        T = len(tok_pos)
        tok_li = line_id[tok_pos]
        tchar = arr[tok_pos]
        is_str_tok = opener_b[tok_pos]
        is_prim_tok = pstart_m[tok_pos]
        # token classes as boolean masks (structural bytes are
        # disjoint from string openers and primitive starts)
        t_oo = tchar == ord('{')
        t_co = tchar == ord('}')
        t_oa = tchar == ord('[')
        t_ca = tchar == ord(']')
        t_comma = tchar == ord(',')
        t_colon = tchar == ord(':')

        # aux: STR -> closing-quote position (the next quote); PRIM ->
        # index into the prim arrays
        tok_aux = np.zeros(T, dtype=np.int64)
        if len(q_pos):
            q_open = outside_b[q_pos]
            qo_idx = np.flatnonzero(q_open)
            close_i = qo_idx + 1
            str_close = np.where(
                close_i < len(q_pos),
                q_pos[np.minimum(close_i, len(q_pos) - 1)],
                n).astype(np.int64)
            tok_aux[is_str_tok] = str_close
        p_start = tok_pos[is_prim_tok]
        tok_aux[is_prim_tok] = np.arange(len(p_start), dtype=np.int64)

        # primitive spans + decode (validation for all; values for the
        # captured subset resolved in _fill_captures)
        prim = self._prep_prims(arr, p_start, p_end,
                                tok_li[is_prim_tok])

        if T == 0:
            fast = elig & ~line_bad
            empty = np.zeros(0, np.int64)
            ebool = np.zeros(0, dtype=bool)
            tok = (tok_pos, tok_aux, tok_li, ebool, ebool, ebool,
                   ebool, empty)
            return fast, [(empty, empty)] * len(self.paths), tok, prim

        # -- bracket depth: a prefix sum over the BRACKET subsequence
        # alone (the only tokens that change depth), mapped back to
        # tokens by a last-bracket index
        is_open_tok = t_oo | t_oa
        is_close_tok = t_co | t_ca
        is_br = is_open_tok | is_close_tok
        # last bracket at-or-before each token
        jmap = np.cumsum(is_br, dtype=np.int32) - 1
        bidx = np.flatnonzero(is_br)
        nb = len(bidx)
        if nb == 0:
            # a line with no brackets cannot start with '{'
            elig[:] = False
            fast = elig
            empty = np.zeros(0, np.int64)
            tok = (tok_pos, tok_aux, tok_li, is_str_tok, is_prim_tok,
                   t_oo, t_oa, empty)
            return fast, [(empty, empty)] * len(self.paths), tok, prim
        bdelta = np.where(is_open_tok[bidx], 1, -1).astype(np.int32)
        bcum = np.cumsum(bdelta, dtype=np.int32)
        b_li = tok_li[bidx]
        # line base: bracket-prefix value before the line's first
        # bracket (fb = index of the first bracket whose token index
        # is at or past the line's first token)
        ft = np.searchsorted(tok_pos, starts)
        fb = np.searchsorted(bidx, ft)
        base_line = np.where(fb > 0, bcum[np.maximum(fb, 1) - 1], 0)
        nbr_line = np.diff(np.concatenate([fb, np.array([nb])]))

        depth_after = np.where(jmap >= 0,
                               bcum[np.maximum(jmap, 0)],
                               0) - base_line[tok_li]
        delta_tok = np.where(is_open_tok, 1,
                             np.where(is_close_tok, -1, 0))
        depth_before = depth_after - delta_tok

        # per-line depth discipline from the bracket prefix sums
        # (depth only changes at brackets, so bracket extremes are the
        # line extremes)
        fbc = np.minimum(fb, nb - 1)
        dmin = np.minimum.reduceat(bcum, fbc) - base_line
        dmax = np.maximum.reduceat(bcum, fbc) - base_line
        lb = np.concatenate([fb[1:], np.array([nb])]) - 1
        dend = np.where(nbr_line > 0,
                        bcum[np.maximum(lb, 0)] - base_line, 0)
        elig &= (nbr_line > 0) & (dend == 0) & (dmin >= 0) & \
            (dmax >= 1) & (dmax <= MAX_DEPTH)

        # a string token whose closing quote lies beyond the line can
        # only happen on odd-quote lines (already ineligible); belt:
        bad_str = is_str_tok & (tok_aux > ends_eff[tok_li])
        if bad_str.any():
            line_bad[tok_li[bad_str]] = True

        # container context: computed on the bracket subsequence (the
        # container in force after each bracket), then spread to
        # tokens via the strictly-previous-bracket index — the
        # container just before a close IS the one being closed, so
        # one definition serves every rule below
        bda = depth_after[bidx]
        bopen = is_open_tok[bidx]
        bobj = t_oo[bidx]
        cafter = np.where(bopen, np.where(bobj, 1, 2),
                          0).astype(np.int8)
        closes_need = ~bopen & (bda >= 1)
        if closes_need.any():
            arb = np.arange(nb)
            maxd = int(min(bda.max(), MAX_DEPTH))
            for d in range(1, maxd + 1):
                need = closes_need & (bda == d)
                if not need.any():
                    continue
                idx = np.where(bopen & (bda == d), arb, -1)
                last = np.maximum.accumulate(idx)
                need_i = np.flatnonzero(need)
                sel = last[need_i]
                good = sel >= 0
                sel_c = np.maximum(sel, 0)
                good &= b_li[sel_c] == b_li[need_i]
                cafter[need_i] = np.where(
                    good, np.where(bobj[sel_c], 1, 2), 0)
                if not good.all():
                    line_bad[b_li[need_i[~good]]] = True
        jprev = jmap - is_br             # bracket strictly before
        jp_ok = jprev >= 0
        jpc = np.maximum(jprev, 0)
        ctx = np.where(jp_ok & (b_li[jpc] == tok_li),
                       cafter[jpc], 0).astype(np.int8)

        # neighbor relations
        same = tok_li[:-1] == tok_li[1:]
        prev_same = np.concatenate([[False], same])
        is_key = is_str_tok & (ctx == 1) & prev_same & \
            np.concatenate([[False], (t_oo | t_comma)[:-1]])

        # first/last token-of-line rules
        first_tok = ~prev_same
        bad_first = first_tok & ~(t_oo & (depth_before == 0))
        if bad_first.any():
            line_bad[tok_li[bad_first]] = True
        valend = is_prim_tok | is_close_tok | (is_str_tok & ~is_key)
        last_tok = ~np.concatenate([same, [False]])
        bad_last = last_tok & ~(valend & (depth_after == 0))
        if bad_last.any():
            line_bad[tok_li[bad_last]] = True

        # close-bracket / container type agreement
        bad_close = (t_co & (ctx != 1)) | (t_ca & (ctx != 2))
        if bad_close.any():
            line_bad[tok_li[bad_close]] = True

        # adjacent-pair grammar within each line: one fused
        # 512-entry table lookup per pair (_PAIR_OK)
        if T >= 2:
            tclass = _TCLASS[tchar]
            key = ((tclass[:-1] << 6) |
                   (is_key[:-1].astype(np.int16) << 5) |
                   (tclass[1:] << 2) | ctx[1:])
            viol = same & ~_PAIR_OK[key]
            if viol.any():
                line_bad[tok_li[1:][viol]] = True

        # primitives that are neither literals nor valid numbers, or
        # over the decode length cap -> the host parser decides
        if len(prim['li']):
            bad_prim = ~(prim['lit'] | prim['accept']) | prim['toolong']
            if bad_prim.any():
                line_bad[prim['li'][bad_prim]] = True

        # -- captures ----------------------------------------------------
        captures = []
        kd1 = np.flatnonzero(is_key & (depth_before == 1))
        kpos = tok_pos[kd1]
        kclose = tok_aux[kd1]
        klen = kclose - kpos - 1
        for fi, kb in enumerate(self._key_bytes):
            L = len(kb)
            m = klen == L
            if not m.any():
                captures.append((np.zeros(0, np.int64),
                                 np.zeros(0, np.int64)))
                continue
            cidx = kd1[m]
            cpos = kpos[m] + 1
            okk = np.ones(len(cidx), dtype=bool)
            for j in range(L):
                okk &= arr[cpos + j] == kb[j]
            mt = cidx[okk]
            vt = mt + 2
            inb = vt < T
            if not inb.all():
                line_bad[tok_li[mt[~inb]]] = True
                mt, vt = mt[inb], vt[inb]
            if len(mt):
                same_l = tok_li[vt] == tok_li[mt]
                if not same_l.all():
                    line_bad[tok_li[mt[~same_l]]] = True
                    mt, vt = mt[same_l], vt[same_l]
            lis = tok_li[mt]
            if len(lis):
                cnt = np.bincount(lis, minlength=nlines)
                dup = cnt > 1
                if dup.any():
                    line_bad |= dup   # duplicate projected key
            captures.append((lis, vt))

        fast = elig & ~line_bad
        # value tokens of captures must be value-starts on fast lines;
        # grammar guarantees it (KEY -> COLON -> value), asserted by
        # the differential tests

        d1close = tok_pos[is_close_tok & (depth_after == 1)]
        tok = (tok_pos, tok_aux, tok_li, is_str_tok, is_prim_tok,
               t_oo, t_oa, d1close)
        return fast, captures, tok, prim

    def _prep_prims(self, arr, p_start, p_end, p_li):
        """Validate every primitive span; decode the number fast path.
        Returns the per-prim arrays _fill_captures indexes into."""
        P = len(p_start)
        out = {'s': p_start, 'e': p_end, 'li': p_li}
        if P == 0:
            z = np.zeros(0, dtype=bool)
            out.update(lit=z, is_true=z, is_false=z, is_null=z,
                       accept=z, toolong=z, value=np.zeros(0),
                       is_int=z, slow=z, intform=z)
            return out
        lens = p_end - p_start
        toolong = lens > MAX_NUM_LEN
        L = int(min(int(lens.max()), MAX_NUM_LEN))
        pad = np.zeros(L, dtype=np.uint8)
        ap = np.concatenate([arr, pad])
        cl = np.minimum(lens, L)
        mat = ap[p_start[:, None] + np.arange(L)]
        mat = np.where(np.arange(L) < cl[:, None], mat, 0)

        def lit(sval):
            lb = sval.encode()
            m = lens == len(lb)
            for j, ch in enumerate(lb):
                if j < L:
                    m = m & (mat[:, j] == ch)
            return m

        is_true = lit('true')
        is_false = lit('false')
        is_null = lit('null')
        literal = is_true | is_false | is_null
        accept, value, is_int, slow, integral = \
            decode_numbers(mat, cl)
        accept &= ~literal & ~toolong
        out.update(lit=literal, is_true=is_true, is_false=is_false,
                   is_null=is_null, accept=accept, toolong=toolong,
                   value=value, is_int=is_int, slow=slow,
                   intform=integral)
        return out

    # -- column fill ---------------------------------------------------------

    def _fill_captures(self, fi, arr, tok, prim, captures, fast_line,
                       row_of_line, tags, nums, strc, dsecs, derr):
        (tok_pos, tok_aux, tok_li, is_str_tok, is_prim_tok, t_oo,
         t_oa, d1close) = tok
        lis, vt = captures[fi]
        if len(lis) == 0:
            return
        keep = fast_line[lis]
        if not keep.any():
            return
        lis = lis[keep]
        vt = vt[keep]
        rows = row_of_line[lis]
        vpos = tok_pos[vt]
        vaux = tok_aux[vt]
        hint = derr is not None
        wd = self.want_dict[fi]

        ms = is_str_tok[vt]
        if ms.any():
            s = vpos[ms] + 1
            e = vaux[ms]
            r = rows[ms]
            tags[r] = TAG_STRING
            if wd:
                strc[r] = self._intern_spans(fi, arr, s, e - s)
            if hint:
                self._dates_from_spans(arr, s, e - s, r, dsecs, derr)

        mp = is_prim_tok[vt]
        if mp.any():
            pidx = vaux[mp]
            r = rows[mp]
            for mask, tag in ((prim['is_true'][pidx], TAG_TRUE),
                              (prim['is_false'][pidx], TAG_FALSE),
                              (prim['is_null'][pidx], TAG_NULL)):
                if mask.any():
                    tags[r[mask]] = tag
                    if hint:
                        derr[r[mask]] = DATE_BAD
            isnum = prim['accept'][pidx]
            if isnum.any():
                pn = pidx[isnum]
                rn = r[isnum]
                vals = prim['value'][pn].copy()
                iints = prim['is_int'][pn].copy()
                slow = prim['slow'][pn]
                if slow.any():
                    ps = prim['s'][pn]
                    pe = prim['e'][pn]
                    intform = prim['intform'][pn]
                    for k in np.flatnonzero(slow):
                        v = float(bytes(arr[int(ps[k]):int(pe[k])]))
                        vals[k] = v
                        iints[k] = bool(
                            intform[k] and abs(v) <= 2 ** 53 and
                            v == np.floor(v))
                tags[rn] = np.where(iints, TAG_INT,
                                    TAG_NUMBER).astype(np.uint8)
                nums[rn] = vals
                if hint:
                    derr[rn] = DATE_OK
                    dsecs[rn] = vals

        mo = t_oo[vt]
        if mo.any():
            tags[rows[mo]] = TAG_OBJECT
            if hint:
                derr[rows[mo]] = DATE_BAD

        ma = t_oa[vt]
        if ma.any():
            r = rows[ma]
            tags[r] = TAG_ARRAY
            if hint:
                derr[r] = DATE_BAD
            if wd:
                s = vpos[ma]
                ci = np.searchsorted(d1close, s)
                ci = np.minimum(ci, max(len(d1close) - 1, 0))
                e = d1close[ci] + 1 if len(d1close) else s
                strc[r] = self._intern_spans(fi, arr, s, e - s)

    def _dates_from_spans(self, arr, s, lens, rows, dsecs, derr):
        """Date-hint decode for captured string spans: the two machine
        shapes vectorized, everything else through the
        jsvalues.date_parse memo (host semantics exactly)."""
        n = len(s)
        if n == 0:
            return
        L = int(min(max(int(lens.max()), 1), 64))
        pad = np.zeros(L, dtype=np.uint8)
        ap = np.concatenate([arr, pad])
        cl = np.minimum(lens, L)
        mat = ap[s[:, None] + np.arange(L)]
        mat = np.where(np.arange(L) < cl[:, None], mat, 0)
        secs, err, need_py = parse_date_spans(mat, lens)
        # spans longer than the gather width can still be valid dates
        # (trailing fractional digits): python path
        need_py |= lens > L
        dsecs[rows] = secs
        derr[rows] = err
        if need_py.any():
            for k in np.flatnonzero(need_py):
                sval = bytes(arr[int(s[k]):int(s[k]) + int(
                    lens[k])]).decode('ascii')
                ms = self._date_python(sval)
                r = rows[k]
                if ms is None:
                    derr[r] = DATE_BAD
                    dsecs[r] = 0.0
                else:
                    derr[r] = DATE_OK
                    dsecs[r] = float(ms // 1000)

    def _fill_fallback(self, row, obj, cols, dates):
        """One host-parsed record into the tagged columns — the same
        value classification the native parser applies, driven from
        the json.loads object."""
        isdict = type(obj) is dict
        for fi, path in enumerate(self.paths):
            v = obj.get(path, jsv.UNDEFINED) if isdict \
                else jsv.UNDEFINED
            if v is jsv.UNDEFINED:
                continue
            tags, nums, strc = cols[fi]
            hint = self.hints[fi]
            d = dates.get(fi)
            if v is None:
                tags[row] = TAG_NULL
                if hint:
                    d[1][row] = DATE_BAD
            elif isinstance(v, bool):
                tags[row] = TAG_TRUE if v else TAG_FALSE
                if hint:
                    d[1][row] = DATE_BAD
            elif isinstance(v, (int, float)):
                f = jsv.as_float(v)
                intish = (f == f and abs(f) <= 2 ** 53 and
                          float(f).is_integer())
                tags[row] = TAG_INT if intish else TAG_NUMBER
                nums[row] = f
                if hint:
                    d[1][row] = DATE_OK
                    d[0][row] = f
            elif isinstance(v, str):
                tags[row] = TAG_STRING
                if self.want_dict[fi]:
                    strc[row] = self._code(fi, v)
                if hint:
                    ms = self._date_python(v)
                    if ms is None:
                        d[1][row] = DATE_BAD
                    else:
                        d[1][row] = DATE_OK
                        d[0][row] = float(ms // 1000)
            elif isinstance(v, list):
                tags[row] = TAG_ARRAY
                if self.want_dict[fi]:
                    raw = json.dumps(v, separators=(',', ':'),
                                     ensure_ascii=False)
                    strc[row] = self._code(fi, raw)
                if hint:
                    d[1][row] = DATE_BAD
            else:
                tags[row] = TAG_OBJECT
                if hint:
                    d[1][row] = DATE_BAD
