"""Typed metrics: counters, gauges, fixed-bucket latency histograms.

Counterpart of dragnet_tpu/obs/metrics.py without its serve-side parts
(request-scoped registries, the device and rollup gauge refreshers),
which come with `dn serve`.  The index build and publish path records
its stage timings here (``timed_stage``):

* ``Counter``    — monotonically increasing count.
* ``Gauge``      — last-set value.
* ``Histogram``  — fixed upper-bound buckets (DN_METRICS_BUCKETS,
  default DEFAULT_BUCKETS_MS) with count/sum and quantile estimates.

Metric identity is ``name`` + optional label pairs
(``observe('stage_ms', 12.5, stage='index_build.commit')``).

The device scan's pipelined dispatch (device_scan._note_dispatch, the
staging ring) writes, and ``pipeline_doc`` reads back:

* ``device_h2d_bytes``            — per-record input bytes uploaded.
* ``device_h2d_pinned_bytes``     — of them, copied from a host buffer
  that was page-locked at the copy (the staging ring's slots).
* ``device_pipe_dispatches``      — device batches dispatched.
* ``device_pipe_overlapped``      — dispatches issued while the previous
  batch still ran on the device, and ``device_h2d_overlapped_bytes``,
  their upload bytes.
* ``device_pipeline_depth`` — gauge: the in-flight window.
"""

import contextlib
import os
import threading
import time

# Default latency buckets (milliseconds).  Upper bounds, ascending;
# +Inf is implicit.  Chosen to straddle the measured serving range:
# warm coalesced hits ~1-15 ms, cold stacked queries ~30-150 ms,
# builds and device first-contact in the seconds.
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

COUNTER, GAUGE, HISTOGRAM = 'counter', 'gauge', 'histogram'


def bucket_bounds(env=None):
    """The configured histogram upper bounds: DN_METRICS_BUCKETS
    (comma-separated, strictly increasing, positive) or the default.
    Malformed values fall back to the default here — config.obs_config
    is where they are REJECTED (dn serve --validate / serve startup);
    a long-lived reader must not crash on an env edit."""
    if env is None:
        env = os.environ
    raw = env.get('DN_METRICS_BUCKETS')
    if not raw:
        return DEFAULT_BUCKETS_MS
    try:
        bounds = tuple(float(p) for p in raw.split(',') if p.strip())
    except ValueError:
        return DEFAULT_BUCKETS_MS
    if not bounds or any(b <= 0 for b in bounds) or \
            any(b >= c for b, c in zip(bounds, bounds[1:])):
        return DEFAULT_BUCKETS_MS
    return bounds


def metric_key(name, labels):
    """Canonical identity: ('op_latency_ms', (('op', 'query'),))."""
    if not labels:
        return (name, ())
    return (name, tuple(sorted(labels.items())))


class Counter(object):
    kind = COUNTER
    __slots__ = ('value',)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def merge(self, other):
        self.value += other.value


class Gauge(object):
    kind = GAUGE
    __slots__ = ('value',)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def merge(self, other):
        # last write wins: a request-scoped gauge overrides on merge
        self.value = other.value


class Histogram(object):
    """Fixed-bucket histogram.  `counts[i]` is the NON-cumulative
    count of observations <= bounds[i]; the final slot is +Inf.
    Export layers cumulate (Prometheus `le` semantics)."""

    kind = HISTOGRAM
    __slots__ = ('bounds', 'counts', 'total', 'sum')

    def __init__(self, bounds=None):
        if bounds is None:
            bounds = bucket_bounds()
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v):
        v = float(v)
        self.total += 1
        self.sum += v
        self.counts[self._slot(v)] += 1

    def _slot(self, v):
        for i, b in enumerate(self.bounds):
            if v <= b:
                return i
        return len(self.bounds)

    def merge(self, other):
        if other.bounds == self.bounds:
            for i, n in enumerate(other.counts):
                self.counts[i] += n
        else:
            # a bucket-layout change mid-flight (env edit between
            # requests): re-bin the other side's mass at its bucket
            # upper bounds — approximate, but never lost or crashed
            for i, n in enumerate(other.counts):
                if not n:
                    continue
                at = other.bounds[min(i, len(other.bounds) - 1)] \
                    if other.bounds else 0.0
                self.counts[self._slot(at)] += n
        self.total += other.total
        self.sum += other.sum

    def quantile(self, q):
        """Bucket-resolution quantile estimate: the upper bound of the
        bucket holding the q-th observation (linear within the bucket
        against its lower bound).  None when empty."""
        if self.total <= 0:
            return None
        rank = q * self.total
        seen = 0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            if seen + n >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] if self.bounds else lo
                frac = (rank - seen) / n
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += n
        return self.bounds[-1] if self.bounds else 0.0


_CTOR = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class Registry(object):
    """A thread-safe metric table keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, kind, name, labels):
        key = metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = _CTOR[kind]()
                self._metrics[key] = m
            elif m.kind != kind:
                raise TypeError('metric %r is a %s, not a %s'
                                % (name, m.kind, kind))
            return m

    def counter(self, name, **labels):
        return self._get(COUNTER, name, labels)

    def gauge(self, name, **labels):
        return self._get(GAUGE, name, labels)

    def histogram(self, name, **labels):
        return self._get(HISTOGRAM, name, labels)

    def inc(self, name, n=1, **labels):
        with self._lock:
            key = metric_key(name, labels)
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter()
            m.inc(n)

    def set_gauge(self, name, v, **labels):
        with self._lock:
            key = metric_key(name, labels)
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Gauge()
            m.set(v)

    def observe(self, name, v, **labels):
        with self._lock:
            key = metric_key(name, labels)
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Histogram()
            m.observe(v)

    def merge(self, other):
        """Fold `other`'s metrics into this registry (request-end
        merge; also how a cluster router will fold replica stats)."""
        with other._lock:
            items = list(other._metrics.items())
        with self._lock:
            for key, m in items:
                mine = self._metrics.get(key)
                if mine is None:
                    mine = self._metrics[key] = _CTOR[m.kind]()
                if mine.kind == m.kind:
                    mine.merge(m)

    def snapshot(self):
        """[(name, labels, metric-copy)] sorted by identity — the
        input both exports consume."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for (name, labels), m in items:
            if m.kind == HISTOGRAM:
                c = Histogram(m.bounds)
                c.counts = list(m.counts)
                c.total = m.total
                c.sum = m.sum
            else:
                c = _CTOR[m.kind]()
                c.value = m.value
            out.append((name, labels, c))
        return out


_GLOBAL = Registry()


def global_registry():
    return _GLOBAL


def reset_global_registry():
    """Test hook."""
    global _GLOBAL
    _GLOBAL = Registry()


def _active_registry():
    """The process-global registry (the reference routes writes inside
    a `dn serve` request scope to the request's registry; the port has
    no request scopes yet)."""
    return _GLOBAL


def inc(name, n=1, **labels):
    _active_registry().inc(name, n, **labels)


def set_gauge(name, v, **labels):
    _active_registry().set_gauge(name, v, **labels)


def observe(name, v, **labels):
    _active_registry().observe(name, v, **labels)


@contextlib.contextmanager
def timed_stage(name, metric='stage_ms', labels=None, **span_attrs):
    """THE shape of per-stage instrumentation: a trace span `name`
    (live only when tracing is on) around the body, and an always-on
    `metric` observation in milliseconds on exit — success OR failure,
    so error paths are accounted like the happy path.  `labels`
    defaults to ``{'stage': name}`` for the shared stage_ms histogram;
    dedicated histograms pass their own (``labels={}`` for none).
    Yields the span for attr updates (``as sp: ... sp.set(...)``)."""
    from . import trace as mod_trace
    if labels is None:
        labels = {'stage': name}
    t0 = time.perf_counter()
    try:
        with mod_trace.span(name, **span_attrs) as sp:
            yield sp
    finally:
        observe(metric, (time.perf_counter() - t0) * 1000.0, **labels)


def pipeline_doc(registry=None):
    """The pipelined-dispatch counters and gauges (the reference serves
    the same numbers in `/stats`)."""
    reg = registry if registry is not None else _GLOBAL
    h2d = reg.counter('device_h2d_bytes').value
    ov = reg.counter('device_h2d_overlapped_bytes').value
    return {
        'depth': int(reg.gauge('device_pipeline_depth').value),
        'dispatches': reg.counter('device_pipe_dispatches').value,
        'overlapped': reg.counter('device_pipe_overlapped').value,
        'h2d_bytes': h2d,
        'h2d_pinned_bytes': reg.counter('device_h2d_pinned_bytes').value,
        'h2d_overlapped_bytes': ov,
        'overlap_ratio': round(ov / h2d, 4) if h2d else 0.0,
    }
