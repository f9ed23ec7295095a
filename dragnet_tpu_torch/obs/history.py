"""Metric history rings: in-process trend storage and windowed rates.

Counterpart of dragnet_tpu/obs/history.py (whole).  The typed
registry (obs/metrics.py) holds LIFETIME totals: a counter
answers "how many ever", never "how many per second lately" — unless
an external Prometheus scrapes it and does the rate math.  This module
is the scraper-free alternative: a background snapshotter
(DN_METRICS_HISTORY_S seconds between samples, **off by default**)
records counter/gauge/histogram-quantile samples into bounded
in-process ring buffers, and a windowed reader derives per-second
rates and window averages over 1m/5m/15m — the qps / shed-rate /
repair-rate / ingest-lag trends `dn top` and the fleet document
render.

Cost model: when DN_METRICS_HISTORY_S is 0 (the default) nothing is
constructed and nothing runs — the serving hot path never sees this
module (the snapshotter reads Registry.snapshot() on its own thread;
request threads pay zero allocations and zero lock traffic for
history).  When on, memory is bounded: one ring per exported series,
each capped to cover the largest window (15m) at the configured
interval.

Sample identity matches the export layer's (`_json_name`): the same
``name{label=value}`` strings /stats renders, so a dashboard can
correlate `history.series` with `metrics.*` directly.  Histograms
export four derived series — ``<name>:count`` (a counter: its rate is
the observation rate, which for ``serve_op_latency_ms`` IS qps),
``<name>:sum``, and ``<name>:p50`` / ``<name>:p95`` (cumulative
quantile estimates, tracked as gauges).

An optional provider callback (the server passes one) contributes
named operational series that live outside the typed registry —
request/shed totals from the admission counters, repair completions,
follow ingest lag — so the headline trends exist even where the
underlying counter predates the typed registry.
"""

import collections
import os
import threading
import time

from . import export as obs_export
from . import metrics as mod_metrics

HISTORY_VERSION = 1

# the windows the reader derives; capacity covers the largest
WINDOWS = (('1m', 60.0), ('5m', 300.0), ('15m', 900.0))
MAX_WINDOW_S = WINDOWS[-1][1]

COUNTER_KIND, GAUGE_KIND = 'counter', 'gauge'


def history_interval_s(env=None):
    """The parsed-but-forgiving DN_METRICS_HISTORY_S (seconds between
    samples; 0 = disabled).  config.obs_config is where malformed
    values are REJECTED — a live reader must not crash on an env
    edit."""
    if env is None:
        env = os.environ
    raw = env.get('DN_METRICS_HISTORY_S')
    if not raw:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


class MetricHistory(object):
    """Bounded per-series rings of (monotonic_ts, value) samples plus
    the windowed-rate reader.  Thread-safe: the snapshotter appends,
    /stats and `dn top` read concurrently."""

    def __init__(self, interval_s):
        self.interval_s = max(1, int(interval_s))
        # +2: one slot of slack past the window edge so the baseline
        # sample straddling the window boundary is still in the ring
        self.capacity = int(MAX_WINDOW_S // self.interval_s) + 2
        self._lock = threading.Lock()
        self._series = {}     # jname -> (kind, deque[(t, value)])
        self.samples = 0      # snapshot passes recorded

    def record(self, jname, kind, value, t=None):
        if t is None:
            t = time.monotonic()
        with self._lock:
            ent = self._series.get(jname)
            if ent is None:
                ent = (kind,
                       collections.deque(maxlen=self.capacity))
                self._series[jname] = ent
            ent[1].append((t, float(value)))

    def sample_registry(self, registry, provider=None):
        """One snapshot pass: record every counter/gauge plus the
        histogram-derived series, and whatever the provider
        contributes ({name: (kind, value)})."""
        t = time.monotonic()
        for name, labels, m in registry.snapshot():
            jname = obs_export._json_name(name, labels)
            if m.kind == mod_metrics.COUNTER:
                self.record(jname, COUNTER_KIND, m.value, t=t)
            elif m.kind == mod_metrics.GAUGE:
                self.record(jname, GAUGE_KIND, m.value, t=t)
            else:
                self.record(jname + ':count', COUNTER_KIND, m.total,
                            t=t)
                self.record(jname + ':sum', COUNTER_KIND, m.sum, t=t)
                for label, q in (('p50', 0.50), ('p95', 0.95)):
                    v = m.quantile(q)
                    if v is not None:
                        self.record('%s:%s' % (jname, label),
                                    GAUGE_KIND, v, t=t)
        if provider is not None:
            try:
                for name, (kind, value) in provider().items():
                    if value is not None:
                        self.record(name, kind, value, t=t)
            except Exception:
                # a provider bug must never kill the snapshotter
                pass
        with self._lock:
            self.samples += 1

    # -- reading ----------------------------------------------------------

    def _window_stats(self, kind, ring, now):
        """{'last': v} + per-window derived values for one ring:
        counters report per-second rates ((last - baseline)/dt, the
        baseline being the OLDEST sample inside the window — honest
        over the actually-covered span), gauges report window
        averages.  A window with fewer than two samples reports
        None — never a fabricated rate."""
        last_t, last_v = ring[-1]
        out = {'last': round(last_v, 6)}
        for wname, wsecs in WINDOWS:
            cutoff = now - wsecs
            inside = [(t, v) for t, v in ring if t >= cutoff]
            key = ('rate_%s' if kind == COUNTER_KIND
                   else 'avg_%s') % wname
            if len(inside) < 2:
                out[key] = None
                continue
            if kind == COUNTER_KIND:
                t0, v0 = inside[0]
                dt = last_t - t0
                if dt <= 0:
                    out[key] = None
                    continue
                # a counter reset (process restart folded into a
                # long-lived reader) reads as a negative delta: clamp
                # to 0 rather than report a negative rate
                out[key] = round(max(0.0, last_v - v0) / dt, 6)
            else:
                out[key] = round(sum(v for _, v in inside)
                                 / len(inside), 6)
        return out

    def series_doc(self, names=None):
        """{jname: {'kind', 'last', 'rate_1m'/'avg_1m', ...}} for
        every ring (or just `names`)."""
        now = time.monotonic()
        with self._lock:
            items = [(jname, kind, list(ring))
                     for jname, (kind, ring) in self._series.items()
                     if ring and (names is None or jname in names)]
        out = {}
        for jname, kind, ring in items:
            doc = self._window_stats(kind, ring, now)
            doc['kind'] = kind
            out[jname] = doc
        return out

    def rate(self, jname, window='1m'):
        """One counter series' per-second rate over `window`, or None
        (unknown series, too few samples)."""
        doc = self.series_doc(names={jname}).get(jname)
        if not doc:
            return None
        return doc.get('rate_%s' % window)

    def doc(self):
        """The /stats `history` section (versioned, like `metrics`)."""
        with self._lock:
            nseries = len(self._series)
            samples = self.samples
        return {'version': HISTORY_VERSION, 'enabled': True,
                'interval_s': self.interval_s,
                'capacity': self.capacity,
                'samples': samples, 'nseries': nseries,
                'series': self.series_doc()}


def disabled_doc():
    """The `history` section when no snapshotter runs: shape-stable
    (version + enabled), zero storage."""
    return {'version': HISTORY_VERSION, 'enabled': False,
            'interval_s': 0, 'capacity': 0, 'samples': 0,
            'nseries': 0, 'series': {}}


class HistorySnapshotter(object):
    """The background sampling thread: every `interval_s` it folds a
    Registry.snapshot() (plus the provider's named series) into a
    MetricHistory.  Stoppable; sampling errors are swallowed (a
    telemetry thread must never take the server down)."""

    def __init__(self, interval_s, registry=None, provider=None,
                 log=None):
        self.history = MetricHistory(interval_s)
        self._registry = registry
        self._provider = provider
        self._log = log
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name='dn-metrics-history', daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)

    def sample_once(self):
        """One synchronous pass (tests, and the first sample at
        start so `last` values exist immediately)."""
        reg = self._registry if self._registry is not None \
            else mod_metrics.global_registry()
        self.history.sample_registry(reg, provider=self._provider)

    def _run(self):
        # sample immediately: a freshly-started server should show a
        # `last` value on the first /stats, not interval_s later
        while True:
            try:
                self.sample_once()
            except Exception as e:
                if self._log is not None:
                    self._log.error('history sample failed',
                                    err=repr(e))
            if self._stop.wait(self.history.interval_s):
                return
