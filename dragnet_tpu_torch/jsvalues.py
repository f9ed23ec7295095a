"""JavaScript value semantics needed for byte-identical behavior parity.

The reference implementation (TritonDataCenter/dragnet) is a Node.js program;
its observable behavior — output formatting, predicate evaluation, date
parsing — leans on JavaScript value semantics.  This module concentrates every
such rule in one place so that the rest of the framework can be written as
straightforward Python/JAX:

* number -> string conversion (JS Number#toString; reference: everywhere a
  value is printed, e.g. bin/dn:1066-1076),
* String(v) coercion incl. null -> "null", missing -> "undefined"
  (reference: skinner aggregation keys, observed in tests/dn goldens),
* loose equality / relational comparison for predicate evaluation
  (reference: krill predicate eval via JS == and < operators,
  lib/krill-skinner-stream.js:38),
* Date.parse for ISO-8601 timestamps, ES5 semantics (missing timezone means
  UTC; reference: lib/stream-synthetic.js:68),
* Date#toISOString (reference: bin/dn:1020-1022, histogram labels),
* JSON.stringify-compatible encoding (reference: --points output,
  bin/dn:972-975; config serialization, lib/config-local.js:101).

Sentinel: JS distinguishes null from undefined (absent).  We represent JS
null as Python None and JS undefined as the UNDEFINED sentinel.
"""

import math
import re
from datetime import datetime, timezone


class _Undefined(object):
    """Sentinel for JavaScript `undefined` (distinct from null/None)."""
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super(_Undefined, cls).__new__(cls)
        return cls._instance

    def __repr__(self):
        return 'undefined'

    def __bool__(self):
        return False


UNDEFINED = _Undefined()


def is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def as_float(v):
    """float(v) with JS overflow semantics: Python ints beyond float64
    range become +-Infinity (JS numbers are doubles throughout)."""
    try:
        return float(v)
    except OverflowError:
        return math.inf if v > 0 else -math.inf


def number_to_string(v):
    """JS Number#toString(10): shortest round-trip decimal.

    Integral floats print without a decimal point (JS has no int/float
    distinction); NaN -> "NaN", Infinity -> "Infinity".  Exponential notation
    kicks in at >= 1e21 or < 1e-6, matching ECMA-262 Number::toString.
    """
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        # JS numbers are doubles: integers beyond 2^53 lose precision and
        # print as the shortest round-trip digits zero-padded, not the
        # exact value.
        if -(1 << 53) <= v <= (1 << 53):
            return str(v)
        v = as_float(v)
    else:
        # normalize numpy scalars (np.float64 subclasses float but its
        # numpy-2.x repr() wraps the value in its type, breaking the
        # shortest-round-trip logic below)
        v = float(v)
    if math.isnan(v):
        return 'NaN'
    if math.isinf(v):
        return 'Infinity' if v > 0 else '-Infinity'
    if v == int(v) and abs(v) < 1e21:
        iv = int(v)
        if -(1 << 53) <= iv <= (1 << 53):
            return str(iv)
        # Shortest round-trip digits, zero-padded (JS Number#toString).
        mant, exp = ('%.17e' % v).split('e')
        s = repr(v)
        if 'e' in s or 'E' in s:
            mant, exp = s.lower().split('e')
        else:
            return s
        digits = mant.replace('.', '').replace('-', '').rstrip('0') or '0'
        sign = '-' if v < 0 else ''
        return sign + digits.ljust(int(exp) + 1, '0')
    # repr() gives the shortest round-trip form, like V8.
    s = repr(v)
    if 'e' in s:
        # Python: 1e+21 / 1e-07; JS: 1e+21 / 1e-7 (no zero-padded exponent)
        mant, exp = s.split('e')
        exp = int(exp)
        s = mant + 'e' + ('+' if exp >= 0 else '-') + str(abs(exp))
    else:
        av = abs(v)
        if av != 0 and av < 1e-6:
            # JS switches to exponential below 1e-6; Python repr does not
            # always.  Convert.
            mant, exp = ('%e' % v).split('e')
            mant = mant.rstrip('0').rstrip('.')
            s = mant + 'e' + ('-' if int(exp) < 0 else '+') + \
                str(abs(int(exp)))
    return s


def to_string(v):
    """JS String(v) coercion."""
    if v is UNDEFINED:
        return 'undefined'
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if is_number(v):
        return number_to_string(v)
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ','.join('' if x is None or x is UNDEFINED else to_string(x)
                        for x in v)
    if isinstance(v, dict):
        return '[object Object]'
    return str(v)


def to_number(v):
    """JS ToNumber coercion.  Returns float (NaN on failure)."""
    if v is UNDEFINED:
        return float('nan')
    if v is None:
        return 0.0
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if is_number(v):
        return as_float(v)
    if isinstance(v, str):
        s = v.strip()
        if s == '':
            return 0.0
        try:
            if s.startswith('0x') or s.startswith('0X'):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return float('nan')
    return float('nan')


def loose_eq(a, b):
    """JS abstract equality (==) for the value types JSON can carry."""
    a_null = a is None or a is UNDEFINED
    b_null = b is None or b is UNDEFINED
    if a_null or b_null:
        return a_null and b_null
    a_num = is_number(a) or isinstance(a, bool)
    b_num = is_number(b) or isinstance(b, bool)
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if a_num and b_num:
        fa, fb = as_float(a), as_float(b)
        return fa == fb and not (math.isnan(fa) or math.isnan(fb))
    if a_num and isinstance(b, str):
        fb = to_number(b)
        return as_float(a) == fb and not math.isnan(fb)
    if isinstance(a, str) and b_num:
        fa = to_number(a)
        return fa == as_float(b) and not math.isnan(fa)
    # object vs primitive: ToPrimitive coerces via toString
    # ([1,2] == "1,2" is true in JS; {} == "[object Object]" too)
    a_obj = isinstance(a, (list, dict))
    b_obj = isinstance(b, (list, dict))
    if a_obj and not b_obj:
        return loose_eq(to_string(a), b)
    if b_obj and not a_obj:
        return loose_eq(a, to_string(b))
    # object vs object: identity
    return a is b


def relational(a, b, op):
    """JS relational comparison (<, <=, >, >=).

    If both operands are strings, compare lexicographically; otherwise
    numerically (NaN makes every comparison false).  Objects coerce via
    ToPrimitive (toString).
    """
    if isinstance(a, (list, dict)):
        a = to_string(a)
    if isinstance(b, (list, dict)):
        b = to_string(b)
    if isinstance(a, str) and isinstance(b, str):
        if op == 'lt':
            return a < b
        if op == 'le':
            return a <= b
        if op == 'gt':
            return a > b
        return a >= b
    fa, fb = to_number(a), to_number(b)
    if math.isnan(fa) or math.isnan(fb):
        return False
    if op == 'lt':
        return fa < fb
    if op == 'le':
        return fa <= fb
    if op == 'gt':
        return fa > fb
    return fa >= fb


_ISO_RE = re.compile(
    r'^(\d{4})(?:-(\d{2})(?:-(\d{2}))?)?'
    r'(?:[T ](\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,6})\d*)?)?'
    r'(Z|[+-]\d{2}:?\d{2})?)?$')


def date_parse(s):
    """JS Date.parse subset: ISO-8601 (ES5: missing offset == UTC).

    Returns milliseconds since epoch, or None (JS NaN) if unparseable.
    Handles the formats dragnet data actually uses: full ISO with 'Z' or
    offset, date-only, and space-separated datetime.
    """
    if not isinstance(s, str):
        return None
    m = _ISO_RE.match(s.strip())
    if m is None:
        return None
    year = int(m.group(1))
    month = int(m.group(2) or 1)
    day = int(m.group(3) or 1)
    hour = int(m.group(4) or 0)
    minute = int(m.group(5) or 0)
    sec = int(m.group(6) or 0)
    frac = m.group(7)
    ms = int((frac or '0').ljust(3, '0')[:3]) if frac else 0
    us = ms * 1000
    tz = m.group(8)
    try:
        dt = datetime(year, month, day, hour, minute, sec, us,
                      tzinfo=timezone.utc)
    except ValueError:
        return None
    epoch_ms = int(dt.timestamp() * 1000)
    # timestamp() can lose sub-ms precision; recompute exactly
    epoch_ms = (int(datetime(year, month, day, hour, minute, sec,
                             tzinfo=timezone.utc).timestamp()) * 1000) + ms
    if tz and tz != 'Z':
        sign = 1 if tz[0] == '+' else -1
        tzh = int(tz[1:3])
        tzm = int(tz[-2:])
        epoch_ms -= sign * (tzh * 60 + tzm) * 60000
    return epoch_ms


def to_iso_string(epoch_ms):
    """JS Date#toISOString: always UTC with milliseconds."""
    ms = int(epoch_ms)
    dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    # avoid float rounding: compute components from integer math
    secs, msec = divmod(ms, 1000)
    dt = datetime.fromtimestamp(secs, tz=timezone.utc)
    return '%04d-%02d-%02dT%02d:%02d:%02d.%03dZ' % (
        dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second, msec)


def _json_escape(s):
    out = []
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == '\\':
            out.append('\\\\')
        elif ch == '\n':
            out.append('\\n')
        elif ch == '\r':
            out.append('\\r')
        elif ch == '\t':
            out.append('\\t')
        elif ch == '\b':
            out.append('\\b')
        elif ch == '\f':
            out.append('\\f')
        elif ord(ch) < 0x20:
            out.append('\\u%04x' % ord(ch))
        else:
            out.append(ch)
    return ''.join(out)


def json_stringify(v):
    """JSON.stringify: compact, insertion-ordered keys, JS number format.

    Properties with value `undefined` are omitted (JS behavior); a top-level
    undefined returns None (JS returns undefined, which console.log prints as
    "undefined").
    """
    if v is UNDEFINED:
        return None
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if is_number(v):
        if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
            return 'null'
        return number_to_string(v)
    if isinstance(v, str):
        return '"' + _json_escape(v) + '"'
    if isinstance(v, (list, tuple)):
        parts = []
        for x in v:
            sv = json_stringify(x)
            parts.append('null' if sv is None else sv)
        return '[' + ','.join(parts) + ']'
    if isinstance(v, dict):
        parts = []
        for k, val in v.items():
            sv = json_stringify(val)
            if sv is None:
                continue
            parts.append('"' + _json_escape(str(k)) + '":' + sv)
        return '{' + ','.join(parts) + '}'
    raise TypeError('cannot stringify %r' % (v,))


def json_parse(text):
    """JSON.parse with V8-compatible error messages (for CLI parity).

    Returns the parsed value; raises ValueError whose message matches V8's
    SyntaxError messages for the common cases exercised by the reference
    tests (e.g. "Unexpected end of input" for truncated input;
    reference: tests/dn/local/tst.badargs.sh.out, tst.config.sh.out).
    """
    import json as _json
    try:
        return _json.loads(text, parse_constant=_reject_nonfinite)
    except _json.JSONDecodeError as e:
        msg = _v8_json_error(text, e)
        raise ValueError(msg)


def _reject_nonfinite(name):
    # Python's json accepts NaN/Infinity/-Infinity as an extension;
    # JSON.parse does not, and downstream engines diverge on non-finite
    # constants (SQL has no literal for them) — reject with the token
    # V8's tokenizer would report.
    raise ValueError('Unexpected token %s' % name.lstrip('-')[0])


def _v8_json_error(text, e):
    if e.pos >= len(text.rstrip()) or 'Expecting' in e.msg and \
            e.pos >= len(text):
        return 'Unexpected end of input'
    if e.pos >= len(text):
        return 'Unexpected end of input'
    ch = text[e.pos] if e.pos < len(text) else ''
    if ch:
        return 'Unexpected token %s' % ch
    return 'Unexpected end of input'


def inspect(v, depth=0):
    """Approximate Node util.inspect() for plain JSON-ish values.

    Used for krill-style error messages, e.g.
    `predicate { junk: [ 'foo', 'bar' ] }: unknown operator "junk"`
    (reference: krill validation, observed in tst.badargs.sh.out).
    """
    if v is None:
        return 'null'
    if v is UNDEFINED:
        return 'undefined'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if is_number(v):
        return number_to_string(v)
    if isinstance(v, str):
        return "'" + v.replace('\\', '\\\\').replace("'", "\\'") + "'"
    if isinstance(v, (list, tuple)):
        if not v:
            return '[]'
        return '[ ' + ', '.join(inspect(x, depth + 1) for x in v) + ' ]'
    if isinstance(v, dict):
        if not v:
            return '{}'
        parts = []
        for k, val in v.items():
            key = k if re.match(r'^[A-Za-z_$][A-Za-z0-9_$]*$', str(k)) \
                else "'" + str(k) + "'"
            parts.append('%s: %s' % (key, inspect(val, depth + 1)))
        return '{ ' + ', '.join(parts) + ' }'
    return str(v)


def pluck(obj, key):
    """jsprim.pluck: direct property first, then split on the first dot.

    This direct-key-first rule is what makes skinner points re-ingestable:
    a point {"req.method": "GET"} round-trips even though the raw record was
    {"req": {"method": "GET"}}.  (reference: jsprim pluckv, used by
    lib/stream-synthetic.js:50 and skinner decomposition.)
    """
    while True:
        if not isinstance(obj, dict):
            return UNDEFINED
        if key in obj:
            return obj[key]
        i = key.find('.')
        if i == -1:
            return UNDEFINED
        obj = obj.get(key[:i], UNDEFINED)
        key = key[i + 1:]
