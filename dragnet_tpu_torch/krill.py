"""Predicate language: JSON AST with eq/ne/lt/le/gt/ge leaves and and/or.

Re-implements the behavior surface of the reference's `krill` dependency
(joyent/node-krill) as used by dragnet (reference: lib/dragnet.js:112-123,
lib/krill-skinner-stream.js:29-52, lib/index-query.js:434-454):

* create(pred) validates the AST, raising DNError with krill-compatible
  messages (`predicate { junk: [ 'foo', 'bar' ] }: unknown operator "junk"`),
* eval_(fields) evaluates with JS comparison semantics (loose == for eq/ne,
  string-vs-numeric relational for lt/le/gt/ge), dotted-path field lookup,
  and an exception when a referenced field is missing (the caller counts
  these as `nfailedeval` drops),
* fields() lists the field names referenced,
* to_c_style() renders a leaf for SQL pushdown (`host == "ralph"`), matching
  krill's toCStyleString used to build index WHERE clauses.

This AST also has a second compilation target: a vectorized mask kernel over
columnar batches (see ops/predicate.py) — the TPU-native equivalent of the
per-record eval loop.
"""

import math

from .errors import DNError
from . import jsvalues as jsv

_RELOPS = ('eq', 'ne', 'lt', 'le', 'gt', 'ge')


class Predicate(object):
    def __init__(self, pred):
        self.p_pred = pred
        self.p_fields = []
        _validate(pred, self.p_fields)

    def fields(self):
        return list(self.p_fields)

    def eval_(self, fields):
        return _eval(self.p_pred, fields)

    def to_c_style(self):
        return _c_style(self.p_pred)

    def always_true(self):
        return not self.p_pred


def create(pred):
    """Validate and compile a predicate.  Raises DNError on invalid input."""
    return Predicate(pred)


def _err(pred, fmt):
    return DNError('predicate %s: %s' % (jsv.inspect(pred), fmt))


def _validate(pred, fields_out):
    if not isinstance(pred, dict):
        raise _err(pred, 'expected object')
    if len(pred) == 0:
        return  # trivial predicate: always true
    if len(pred) != 1:
        raise _err(pred, 'expected exactly one key')
    op = next(iter(pred))
    val = pred[op]
    if op in ('and', 'or'):
        if not isinstance(val, list) or len(val) == 0:
            raise _err(pred, '"%s" operator requires a nonempty list' % op)
        for sub in val:
            _validate(sub, fields_out)
        return
    if op not in _RELOPS:
        raise _err(pred, 'unknown operator "%s"' % op)
    if not isinstance(val, list) or len(val) != 2:
        raise _err(pred, 'expected 2 arguments')
    field, value = val
    if not isinstance(field, str):
        raise _err(pred, 'field name must be a string')
    if not (isinstance(value, str) or jsv.is_number(value) or
            isinstance(value, bool)):
        raise _err(pred, 'value must be a string, number, or boolean')
    if isinstance(value, float) and not math.isfinite(value):
        # unreachable through JSON (JSON.parse has no non-finite
        # literals, and jsvalues.json_parse matches); guard the
        # library path — SQL pushdown has no literal for these
        raise _err(pred, 'value must be a finite number')
    if field not in fields_out:
        fields_out.append(field)


class EvalError(Exception):
    """Predicate evaluation failure (missing field); counted as nfailedeval."""


def _eval(pred, fields):
    if len(pred) == 0:
        return True
    op = next(iter(pred))
    val = pred[op]
    if op == 'and':
        return all(_eval(sub, fields) for sub in val)
    if op == 'or':
        return any(_eval(sub, fields) for sub in val)
    field, value = val
    fv = jsv.pluck(fields, field)
    if fv is jsv.UNDEFINED:
        raise EvalError('field "%s" is not present' % field)
    if op == 'eq':
        return jsv.loose_eq(fv, value)
    if op == 'ne':
        return not jsv.loose_eq(fv, value)
    return jsv.relational(fv, value, op)


_C_OPS = {'eq': '==', 'ne': '!=', 'lt': '<', 'le': '<=', 'gt': '>',
          'ge': '>='}


def _c_style(pred):
    if len(pred) == 0:
        return '1'
    op = next(iter(pred))
    val = pred[op]
    if op == 'and':
        return ' && '.join('(%s)' % _c_style(s) for s in val)
    if op == 'or':
        return ' || '.join('(%s)' % _c_style(s) for s in val)
    field, value = val
    if isinstance(value, str):
        vs = '"%s"' % value
    elif isinstance(value, bool):
        vs = 'true' if value else 'false'
    else:
        vs = jsv.number_to_string(value)
    return '%s %s %s' % (field, _C_OPS[op], vs)
