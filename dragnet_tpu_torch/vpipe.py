"""Per-stage counters and warnings for the host data pipeline.

Counterpart of dragnet_tpu/vpipe.py.  The reference wraps every stream
with vstream for per-stage counters and warnings (`dn --counters`;
reference: bin/dn:902-916, lib/krill-skinner-stream.js:44-48).  A
Pipeline is an ordered list of Stage objects, each with named counters
(dumped alphabetically, matching vstream's output).

Counter dump format is byte-compatible with vstream vsDumpCounters:
    name %-18s, space, counter+':' %-13s, value %8d
(measured from tests/dn golden output).

Hidden telemetry counters additionally mirror into a process-global
store with REQUEST SCOPING (`counter_bump` / `request_scope`): inside a
scope — one per `dn serve` request — bumps land in a thread-local
snapshot that merges into the global store when the scope exits, so
concurrent server requests never interleave each other's "index shards
pruned/queried" / parse-lane / cache-hit deltas, and each request can
report exactly its own.  With no scope active (the single-process CLI)
bumps go straight to the global store and nothing else changes — the
--counters byte format above is untouched either way.
"""

import contextlib
import sys
import threading

_GLOBAL_LOCK = threading.Lock()
_GLOBAL_COUNTERS = {}
_SCOPE_TLS = threading.local()


class Scope(dict):
    """One request's counter snapshot.  A dict (the counter deltas the
    docstring above describes) plus one extra slot: `obs`, the
    request's observability context (obs/trace.py spans + scoped
    metrics).  Because worker pools capture and adopt THE SCOPE OBJECT
    (current_scope/adopt_scope), hanging the obs context off it means
    pool-thread spans and metrics attribute to the submitting request
    with zero extra plumbing."""

    __slots__ = ('obs',)

    def __init__(self):
        super(Scope, self).__init__()
        self.obs = None


def counter_bump(counter, n=1):
    """Bump a process-global telemetry counter, request-scoped when a
    scope is active on this thread (see module docstring).  Scope
    writes take the lock too: worker pools adopt their submitter's
    scope (adopt_scope), so one scope dict may be bumped from several
    threads at once."""
    scope = getattr(_SCOPE_TLS, 'scope', None)
    if scope is not None:
        with _GLOBAL_LOCK:
            scope[counter] = scope.get(counter, 0) + n
        return
    with _GLOBAL_LOCK:
        _GLOBAL_COUNTERS[counter] = _GLOBAL_COUNTERS.get(counter, 0) + n


@contextlib.contextmanager
def request_scope():
    """Collect this thread's counter_bump deltas into a private dict
    (yielded), merging them into the global store — or the enclosing
    scope — on exit.  The serving layer wraps every request in one."""
    prior = getattr(_SCOPE_TLS, 'scope', None)
    scope = Scope()
    # a nested scope still belongs to the enclosing request's trace
    scope.obs = getattr(prior, 'obs', None)
    _SCOPE_TLS.scope = scope
    try:
        yield scope
    finally:
        _SCOPE_TLS.scope = prior
        target = _GLOBAL_COUNTERS if prior is None else prior
        if scope:
            with _GLOBAL_LOCK:
                for counter, n in scope.items():
                    target[counter] = target.get(counter, 0) + n


def current_scope():
    """This thread's active counter scope (or None) — worker pools
    capture it at construction and adopt it on their threads, so
    counters bumped by pool workers still attribute to the request
    that submitted the work."""
    return getattr(_SCOPE_TLS, 'scope', None)


@contextlib.contextmanager
def adopt_scope(scope):
    """Install a scope captured by current_scope() on THIS thread for
    the duration (no-op when scope is None).  Unlike request_scope,
    exiting does not merge — the owning request's scope exit does."""
    prior = getattr(_SCOPE_TLS, 'scope', None)
    _SCOPE_TLS.scope = scope if scope is not None else prior
    try:
        yield
    finally:
        _SCOPE_TLS.scope = prior


def global_counters():
    """Snapshot of the merged global counter store (`dn serve`'s
    /stats view; in-scope deltas appear only after their scope
    exits)."""
    with _GLOBAL_LOCK:
        return dict(_GLOBAL_COUNTERS)


def reset_global_counters():
    """Test hook."""
    with _GLOBAL_LOCK:
        _GLOBAL_COUNTERS.clear()


class Stage(object):
    def __init__(self, name, pipeline=None):
        self.name = name
        self.counters = {}
        self.hidden = set()    # telemetry counters kept out of dump()
        self.pipeline = pipeline

    def bump(self, counter, n=1):
        self.counters[counter] = self.counters.get(counter, 0) + n

    def warn(self, error, kind):
        self.bump(kind)
        if self.pipeline is not None and self.pipeline.warn_func is not None:
            self.pipeline.warn_func(self, kind, error)

    def bump_hidden(self, counter, n=1):
        """Bump a telemetry counter that stays out of the --counters
        dump (whose byte format is pinned to the reference goldens
        regardless of engine); still visible programmatically via
        Stage.counters, and mirrored into the request-scoped global
        store so `dn serve` can attribute deltas per request."""
        self.hidden.add(counter)
        self.bump(counter, n)
        counter_bump(counter, n)

    def dump(self, out):
        # DN_COUNTERS_ALL=1 includes hidden telemetry counters (engine
        # batches, index-shard fan-out) in the --counters dump; default
        # output stays byte-pinned to the reference goldens
        import os
        show_hidden = os.environ.get('DN_COUNTERS_ALL') == '1'
        for counter in sorted(self.counters):
            value = self.counters[counter]
            if value == 0 or (counter in self.hidden
                              and not show_hidden):
                continue
            out.write('%-18s %-13s%8d\n' % (self.name, counter + ':', value))


class Pipeline(object):
    def __init__(self):
        self.stages = []
        self.warn_func = None

    def stage(self, name):
        s = Stage(name, self)
        self.stages.append(s)
        return s

    def dump_counters(self, out=None):
        if out is None:
            out = sys.stderr
        for s in self.stages:
            s.dump(out)
