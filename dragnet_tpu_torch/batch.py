"""Columnar record batches: the vectorized representation of the scan
input.

Counterpart of dragnet_tpu/batch.py.  A batch columnarizes the fields a
query needs (projection from the query plan — breakdowns, filter
fields, synthetic date sources, time field):

* key columns (non-aggregated breakdowns) are dictionary-encoded on their
  String(v) form (null -> "null", missing -> "undefined" — the skinner
  keying rule),
* aggregated (quantize/lquantize) columns are coerced to f64 with a
  validity mask (numeric strings coerce; anything else drops the record),
* filter columns are dictionary-encoded on their raw JS value so each
  predicate leaf is evaluated once per *unique* value with exact JS
  semantics, then broadcast to records as a table gather,
* date columns are parsed ISO-8601 -> epoch seconds with undef/baddate
  classification (stream-synthetic.js rules).

The plucking helpers serve the record path (engine.DictColumns: parsed
records without the native parser); the native and byte-lane parsers
produce the same columns directly.  Dictionaries are global per column
(append-only across batches) so codes are stable and per-batch partial
aggregates merge cheaply.
"""

import numpy as np

from . import jsvalues as jsv


class ValueDict(object):
    """Append-only dictionary over hashable JS-value identities."""

    def __init__(self):
        self.index = {}
        self.values = []

    def code(self, key, value):
        c = self.index.get(key)
        if c is None:
            c = len(self.values)
            self.index[key] = c
            self.values.append(value)
        return c


def js_value_key(v):
    """Hashable identity preserving JS comparison class."""
    if v is jsv.UNDEFINED:
        return ('u',)
    if v is None:
        return ('0',)
    if isinstance(v, bool):
        return ('b', v)
    if jsv.is_number(v):
        return ('n', jsv.as_float(v))
    if isinstance(v, str):
        return ('s', v)
    if isinstance(v, list):
        # arrays compare via ToPrimitive (join), so their string form is
        # exactly their comparison-equivalence class
        return ('a', jsv.to_string(v))
    return ('o',)  # plain objects all coerce to "[object Object]"


class StringColumn(object):
    """Dictionary-encoded String(v) column with a global dictionary."""

    def __init__(self):
        self.dict = ValueDict()

    def encode(self, values):
        index = self.dict.index
        vals = self.dict.values
        get = index.get
        to_string = jsv.to_string
        out = np.empty(len(values), dtype=np.int64)
        for i, v in enumerate(values):
            s = v if type(v) is str else to_string(v)
            c = get(s)
            if c is None:
                c = len(vals)
                index[s] = c
                vals.append(s)
            out[i] = c
        return out


class RawColumn(object):
    """Dictionary-encoded raw-JS-value column (for filter evaluation)."""

    def __init__(self):
        self.dict = ValueDict()

    def encode(self, values):
        code = self.dict.code
        return np.array([code(js_value_key(v), v) for v in values],
                        dtype=np.int64)


def numeric_column(values):
    """Coerce to f64 with validity (bucketizer input rules: numbers pass,
    numeric strings coerce, everything else is invalid)."""
    n = len(values)
    out = np.empty(n, dtype=np.float64)
    valid = np.ones(n, dtype=bool)
    for i, v in enumerate(values):
        if isinstance(v, bool):
            valid[i] = False
            out[i] = 0.0
        elif isinstance(v, (int, float)):
            out[i] = jsv.as_float(v)
        elif isinstance(v, str):
            f = jsv.to_number(v)
            if f != f:
                valid[i] = False
                out[i] = 0.0
            else:
                out[i] = f
        else:
            valid[i] = False
            out[i] = 0.0
    return out, valid


UNDEF, BADDATE = 1, 2


def date_column(values):
    """Parse date-typed fields: numbers pass through, strings via
    Date.parse -> floor(ms/1000); returns (seconds f64, errkind u8)."""
    n = len(values)
    out = np.zeros(n, dtype=np.float64)
    err = np.zeros(n, dtype=np.uint8)
    cache = {}
    for i, v in enumerate(values):
        if v is jsv.UNDEFINED:
            err[i] = UNDEF
        elif jsv.is_number(v) and not isinstance(v, bool):
            out[i] = jsv.as_float(v)
        else:
            key = v if isinstance(v, str) else None
            ms = cache.get(key, -1)
            if ms == -1:
                ms = jsv.date_parse(v) if isinstance(v, str) else None
                if isinstance(v, str):
                    cache[key] = ms
            if ms is None:
                err[i] = BADDATE
            else:
                out[i] = ms // 1000
    return out, err


def pluck_column(records, path):
    """Column extraction with fast paths for flat and two-level paths
    (full jsprim-pluck semantics preserved: direct key first, then split
    on the first dot)."""
    UD = jsv.UNDEFINED
    if '.' not in path:
        return [r.get(path, UD) if type(r) is dict else UD
                for r in records]
    head, tail = path.split('.', 1)
    if '.' not in tail:
        out = []
        append = out.append
        for r in records:
            if type(r) is not dict:  # scalar top-level JSON lines
                append(UD)
                continue
            v = r.get(path, UD)
            if v is UD:
                sub = r.get(head)
                if type(sub) is dict:
                    v = sub.get(tail, UD)
            append(v)
        return out
    pluck = jsv.pluck
    return [pluck(r, path) for r in records]
