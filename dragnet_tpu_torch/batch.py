"""Dictionary-encoded key columns and date-error codes for the scan
engine (the parts of dragnet_tpu/batch.py the native-parser lane uses).

Key columns (non-aggregated breakdowns) are dictionary-encoded on their
String(v) form (null -> "null", missing -> "undefined" — the skinner
keying rule).  Dictionaries are global per column (append-only across
batches) so codes are stable and per-batch partial aggregates merge
cheaply.
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


# date-error codes of the parser's date columns
UNDEF, BADDATE = 1, 2
