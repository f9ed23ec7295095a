"""Structured per-request span trees.

"Where did this 40 ms query go?"  A request — one CLI data command,
or one `dn serve` request — owns a TraceContext: a tree of Spans
covering the real execution stages (parse lane, scan fan-out, stacked
load/sort/aggregate, per-shard reads, build prepare/commit/publish,
device probe and transfers, serve queue-wait/coalesce/execute; the
full catalog is docs/observability.md).  When the request ends, the
tree is emitted as ONE JSON line to the DN_TRACE sink (``stderr`` or
a file path), and — independently — to stderr when the request ran
longer than DN_SLOW_MS (the slow-request log, usable with tracing
otherwise dark).

Cost model: tracing is FULLY OFF by default.  Every seam calls
``span(...)`` / ``event(...)``, which reduce to a thread-local read
and a None check when no context is active — and a context only
exists when DN_TRACE / DN_SLOW_MS / ``--trace`` / a remote trace
header asked for one.  The always-on metrics live in obs/metrics.py,
not here.

Attribution rides the vpipe request scope: the context hangs off
``vpipe.Scope.obs``, worker pools adopt their submitter's scope
(scan_mt / index_query_mt already do, for counters), so a span opened
on a pool thread lands in the right request's tree.  Each thread
keeps its own span stack inside the context; a pool thread with no
open parent attaches to the root span, tagged with its thread name.

Trace ids are generated CLIENT-side (uuid4 hex) and propagate through
the `--remote` protocol header (``req['trace']``), so a server-side
trace joins its client: the server serializes its subtree into the
response header and the client grafts it into its own tree — one
joined span tree per remote request.
"""

import contextlib
import json
import os
import sys
import threading
import time
import uuid

from . import metrics as mod_metrics
from .. import vpipe as mod_vpipe


def _obs_env():
    """(trace_sink, slow_ms): the parsed-but-forgiving view of
    DN_TRACE / DN_SLOW_MS.  config.obs_config is where malformed
    values are REJECTED; here a bad DN_SLOW_MS reads as disabled so a
    live server never crashes on an env edit."""
    sink = os.environ.get('DN_TRACE') or None
    raw = os.environ.get('DN_SLOW_MS')
    slow = None
    if raw:
        try:
            slow = max(0, int(raw))
        except ValueError:
            slow = None
    return sink, slow


def tracing_requested():
    """True when the environment asks for span collection (DN_TRACE
    set, or DN_SLOW_MS armed — the slow log needs the tree)."""
    sink, slow = _obs_env()
    return sink is not None or slow is not None


class Span(object):
    __slots__ = ('name', 'attrs', 'events', 'children', 't0', '_pc0',
                 'dur_ms', 'thread')

    def __init__(self, name, attrs=None):
        self.name = name
        self.attrs = attrs or None
        self.events = None
        self.children = None
        self.t0 = time.perf_counter()
        self.dur_ms = None
        self.thread = None

    def finish(self):
        if self.dur_ms is None:
            self.dur_ms = (time.perf_counter() - self.t0) * 1000.0

    def add_child(self, child):
        if self.children is None:
            self.children = []
        self.children.append(child)

    def add_event(self, name, attrs):
        if self.events is None:
            self.events = []
        self.events.append({'name': name, **(attrs or {})})

    def to_doc(self, origin_pc):
        # copies, not references: an abandoned (deadline-expired) job
        # thread may still be mutating attrs/events/children while the
        # serve path serializes its tree
        doc = {'name': self.name,
               't0_ms': round((self.t0 - origin_pc) * 1000.0, 3),
               'dur_ms': round(self.dur_ms, 3)
               if self.dur_ms is not None else None}
        if self.attrs:
            doc['attrs'] = dict(self.attrs)
        if self.thread:
            doc['thread'] = self.thread
        if self.events:
            doc['events'] = list(self.events)
        if self.children:
            doc['children'] = [c.to_doc(origin_pc)
                               for c in list(self.children)]
        return doc


class TraceContext(object):
    """One request's span tree + per-thread span stacks."""

    def __init__(self, op, trace_id=None):
        self.trace_id = trace_id or new_trace_id()
        self.op = op
        self.root = Span(op)
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self):
        st = getattr(self._tls, 'stack', None)
        if st is None:
            st = self._tls.stack = []
        return st

    def push(self, span):
        st = self._stack()
        with self._lock:
            if st:
                st[-1].add_child(span)
            else:
                # a pool thread's first span: attach to the root,
                # tagged so the tree reads correctly
                t = threading.current_thread()
                if t is not threading.main_thread():
                    span.thread = t.name
                self.root.add_child(span)
        st.append(span)

    def pop(self, span):
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        span.finish()

    def add_event(self, name, attrs):
        st = self._stack()
        with self._lock:
            (st[-1] if st else self.root).add_event(name, attrs)

    def graft(self, doc):
        """Attach a remote subtree (the server's serialized spans) as
        a child of this thread's current span."""
        if not isinstance(doc, dict):
            return
        st = self._stack()
        remote = Span(doc.get('name') or 'remote')
        remote.dur_ms = doc.get('dur_ms')
        remote.attrs = doc.get('attrs')
        remote.events = doc.get('events')
        # keep the serialized children verbatim (already docs)
        remote_children = doc.get('children')
        if remote_children:
            remote.children = [_DocSpan(c) for c in remote_children]
        with self._lock:
            (st[-1] if st else self.root).add_child(remote)

    def to_doc(self):
        self.root.finish()
        # under the tree lock so a concurrent push (an abandoned job
        # thread that outlived its deadline) cannot grow a children
        # list mid-walk
        with self._lock:
            spans = self.root.to_doc(self.root.t0)
        return {
            'trace': self.trace_id,
            'op': self.op,
            'ts': round(self.started_at, 3),
            'dur_ms': round(self.root.dur_ms, 3),
            'spans': spans,
        }


class _DocSpan(object):
    """An already-serialized span (a grafted remote subtree node):
    quacks like Span for to_doc only."""

    __slots__ = ('doc',)

    def __init__(self, doc):
        self.doc = doc if isinstance(doc, dict) else {'name': str(doc)}

    def to_doc(self, origin_pc):
        return self.doc


def new_trace_id():
    return uuid.uuid4().hex


# -- context discovery (rides the vpipe scope) ------------------------------

class ObsContext(object):
    """What hangs off vpipe.Scope.obs: the optional trace context and
    the request-scoped metrics registry."""

    __slots__ = ('trace', 'registry')

    def __init__(self, trace=None, registry=None):
        self.trace = trace
        self.registry = registry


def current():
    """This thread's active ObsContext, or None."""
    return getattr(mod_vpipe.current_scope(), 'obs', None)


def current_trace():
    """The active TraceContext or None — per-item hot paths (one call
    per shard) use this as THE cheap is-tracing-on check before
    building span attrs."""
    obs = getattr(mod_vpipe.current_scope(), 'obs', None)
    return obs.trace if obs is not None else None


class _NullSpan(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()

# the no-op span, exported for per-item hot paths that check
# current_trace() themselves to skip attr construction entirely
NULL_SPAN = _NULL


class _LiveSpan(object):
    __slots__ = ('ctx', 'span')

    def __init__(self, ctx, span):
        self.ctx = ctx
        self.span = span

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ctx.pop(self.span)
        return False

    def set(self, **attrs):
        if self.span.attrs is None:
            self.span.attrs = {}
        self.span.attrs.update(attrs)
        return self


def span(name, **attrs):
    """Open a span under the current trace context; a no-op context
    manager when tracing is off (one TLS read + None check)."""
    ctx = current_trace()
    if ctx is None:
        return _NULL
    s = Span(name, attrs or None)
    ctx.push(s)
    return _LiveSpan(ctx, s)


def add_span(name, dur_ms, **attrs):
    """Record an already-measured span (stages that accumulate their
    own timing, like the parse lane's per-batch work, report one
    synthesized span at the end)."""
    ctx = current_trace()
    if ctx is None:
        return
    s = Span(name, attrs or None)
    s.t0 = ctx.root.t0
    s.dur_ms = float(dur_ms)
    ctx.push(s)
    ctx.pop(s)


def event(name, **attrs):
    """Attach an instant event (fault firings, cache invalidations)
    to the current span; no-op when tracing is off."""
    ctx = current_trace()
    if ctx is not None:
        ctx.add_event(name, attrs or None)


# -- request lifecycle ------------------------------------------------------

@contextlib.contextmanager
def request(op, trace_id=None, force=False, emit=True):
    """Wrap one request: installs a vpipe scope carrying an
    ObsContext (scoped metrics registry always; a TraceContext when
    tracing was requested or `force` is set), and on exit merges the
    scoped metrics into the global registry and emits the trace line
    / slow log.  Yields the ObsContext."""
    from .. import vpipe
    want_trace = force or tracing_requested()
    tctx = TraceContext(op, trace_id) if want_trace else None
    obs = ObsContext(trace=tctx, registry=mod_metrics.Registry())
    with vpipe.request_scope() as scope:
        scope.obs = obs
        try:
            yield obs
        finally:
            scope.obs = None
            mod_metrics.global_registry().merge(obs.registry)
            if tctx is not None and emit:
                emit_trace(tctx)


def emit_trace(tctx):
    """Write the finished trace: one JSON line to the DN_TRACE sink,
    plus the slow-request log line to stderr when the request beat
    DN_SLOW_MS (marked ``"slow": true``)."""
    sink, slow_ms = _obs_env()
    doc = tctx.to_doc()
    slow = slow_ms is not None and doc['dur_ms'] >= slow_ms
    if slow:
        doc['slow'] = True
        doc['slow_ms'] = slow_ms
    if sink is None and not slow:
        return
    line = json.dumps(doc, sort_keys=True,
                      separators=(',', ':')) + '\n'
    if sink is not None:
        _write_sink(sink, line)
    if slow and sink != 'stderr':
        _write_sink('stderr', line)


_SINK_LOCK = threading.Lock()


def _write_sink(sink, line):
    """stderr -> the PROCESS stderr (never a serve request's bound
    capture buffer: trace lines are operator telemetry, not response
    bytes); anything else is an append-to path."""
    try:
        if sink == 'stderr':
            stream = getattr(sys, '__stderr__', None) or sys.stderr
            with _SINK_LOCK:
                stream.write(line)
                stream.flush()
        else:
            with _SINK_LOCK, open(sink, 'a') as f:
                f.write(line)
    except OSError:
        pass
