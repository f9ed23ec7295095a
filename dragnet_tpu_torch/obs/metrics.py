"""Typed metrics: counters, gauges, fixed-bucket latency histograms.

Counterpart of dragnet_tpu/obs/metrics.py.  The index build and publish
path records its stage timings here (``timed_stage``), and `dn serve`
its per-op latencies:

* ``Counter``    — monotonically increasing count.
* ``Gauge``      — last-set value.
* ``Histogram``  — fixed upper-bound buckets (DN_METRICS_BUCKETS,
  default DEFAULT_BUCKETS_MS) with count/sum and quantile estimates.

Metric identity is ``name`` + optional label pairs
(``observe('stage_ms', 12.5, stage='index_build.commit')``).

Writes route through the module helpers (``inc`` / ``set_gauge`` /
``observe``): inside a request scope that carries an obs context
(vpipe.Scope.obs) they land in the request's private registry, merged
into the process registry when the request ends; otherwise in the
process-global one.

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

from .. import vpipe as mod_vpipe

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
    """The request-scoped registry when this thread is inside a scope
    whose obs context carries one, else the global registry."""
    obs = getattr(mod_vpipe.current_scope(), 'obs', None)
    reg = getattr(obs, 'registry', None)
    return reg if reg is not None else _GLOBAL


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


# -- device gauges (ROADMAP open item 4: the reporting half) ---------------

_DEVICE_COUNTER_GAUGES = (
    ('ndevicebatches', 'device_batches'),
    ('nstackedbatches', 'device_stacked_batches'),
    ('index device sums', 'device_index_sums'),
)

# serve/residency.py registers its stats() here at configure time (and
# clears it at drain) — obs stays import-independent of the serve
# package while the device gauges still see pinned-memory truth
_RESIDENCY_SOURCE = None


def set_residency_source(fn):
    """Install (or clear, fn=None) the device-residency stats provider
    refresh_device_gauges consults: a zero-arg callable returning the
    serve/residency.py stats doc."""
    global _RESIDENCY_SOURCE
    _RESIDENCY_SOURCE = fn


def refresh_device_gauges(counters, registry=None):
    """Wire the device-lane engagement picture into typed gauges from
    the existing hidden counters (vpipe.global_counters()):

    * ``device_engaged``          — 1.0 when any device-lane counter
      is non-zero (the same signal /stats' `device.engaged` reports).
    * ``device_batches`` / ``device_stacked_batches`` /
      ``device_index_sums``      — the raw engagement counters.
    * ``device_residency_pct``   — share of engine batches that ran on
      the device lane (device / (device + host)); 0 when nothing ran.
    * ``device_mfu_pct``         — measured device records/s against
      the rig's calibrated peak (DN_DEVICE_PEAK_RECORDS_PER_SEC).
      HONEST ZEROS: without a measured device rate (CPU rigs, host
      lane) and a calibrated peak, this reports 0.0 rather than a
      guess.  device_scan sets `device_records_per_sec` when the
      device lane actually measures a window.
    * ``device_residency_hit_rate`` / ``device_pinned_bytes`` /
      ``device_h2d_saved_bytes`` / ``device_d2h_saved_bytes`` — HBM
      residency (serve/residency.py), present only when a serve
      process has configured it (set_residency_source).
    """
    reg = registry if registry is not None else _GLOBAL
    total_dev = 0
    for counter, gauge in _DEVICE_COUNTER_GAUGES:
        v = int(counters.get(counter, 0) or 0)
        total_dev += v
        reg.set_gauge(gauge, v)
    reg.set_gauge('device_engaged', 1.0 if total_dev else 0.0)
    host_batches = int(counters.get('nhostbatches', 0) or 0)
    dev_batches = int(counters.get('ndevicebatches', 0) or 0) + \
        int(counters.get('nstackedbatches', 0) or 0)
    denom = host_batches + dev_batches
    reg.set_gauge('device_residency_pct',
                  100.0 * dev_batches / denom if denom else 0.0)
    rate = 0.0
    with reg._lock:
        for (n, _lb), m in reg._metrics.items():
            if n == 'device_records_per_sec' and m.kind == GAUGE:
                rate = max(rate, float(m.value))
    peak = 0.0
    try:
        peak = float(os.environ.get(
            'DN_DEVICE_PEAK_RECORDS_PER_SEC', '0') or 0)
    except ValueError:
        peak = 0.0
    mfu = 100.0 * rate / peak if (rate > 0 and peak > 0) else 0.0
    reg.set_gauge('device_mfu_pct', mfu)
    src = _RESIDENCY_SOURCE
    if src is not None:
        try:
            rs = src() or {}
        except Exception:
            rs = {}
        if rs.get('enabled'):
            reg.set_gauge('device_residency_hit_rate',
                          float(rs.get('hit_rate', 0.0) or 0.0))
            reg.set_gauge('device_pinned_bytes',
                          float(rs.get('bytes', 0) or 0))
            reg.set_gauge('device_h2d_saved_bytes',
                          float(rs.get('h2d_saved_bytes', 0) or 0))
            reg.set_gauge('device_d2h_saved_bytes',
                          float(rs.get('d2h_saved_bytes', 0) or 0))


def refresh_rollup_gauges(counters, registry=None):
    """Rollup-planner engagement from the hidden query counters:

    * ``rollup_covered_shards_total`` / ``rollup_shards_read_total``
      — fine shards whose answers came from rollups, and the coarse
      shards actually read for them.
    * ``rollup_coverage_pct`` — share of all fine-shard reads the
      planner served from rollups (0 when nothing ran; honest zero,
      like the device gauges).
    """
    reg = registry if registry is not None else _GLOBAL
    covered = int(counters.get('index shards via rollup', 0) or 0)
    read = int(counters.get('rollup shards queried', 0) or 0)
    queried = int(counters.get('index shards queried', 0) or 0)
    reg.set_gauge('rollup_covered_shards_total', covered)
    reg.set_gauge('rollup_shards_read_total', read)
    reg.set_gauge('rollup_coverage_pct',
                  100.0 * covered / queried if queried else 0.0)
