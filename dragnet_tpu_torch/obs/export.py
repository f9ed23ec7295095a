"""Metric exports: the /stats ``metrics`` section and Prometheus
text exposition.

Two renderings of one Registry.snapshot():

* ``stats_section(registry)`` — the versioned JSON document `/stats`
  embeds (STATS_METRICS_VERSION guards dashboards: additive changes
  keep the version, breaking changes bump it).  Histograms carry
  count/sum, the raw cumulative buckets, and p50/p90/p99 estimates.
* ``prometheus_text(registry)`` — text exposition (version 0.0.4):
  every metric prefixed ``dn_``, labels rendered, histograms as the
  canonical ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet with
  CUMULATIVE bucket counts.  This is what the serve ``metrics`` op
  and ``dn stats --prom`` return.
"""

from . import metrics as mod_metrics

STATS_METRICS_VERSION = 1

QUANTILES = (('p50', 0.50), ('p90', 0.90), ('p99', 0.99))


def _label_str(labels):
    return ','.join('%s=%s' % (k, v) for k, v in labels)


def _json_name(name, labels):
    return name if not labels else '%s{%s}' % (name,
                                               _label_str(labels))


def stats_section(registry=None, counters=None):
    """The /stats ``metrics`` document.  When `counters` (the hidden
    vpipe global counters) is given, the device gauges are refreshed
    from it first, so every export carries the current engagement
    picture — including the HBM residency gauges
    (device_residency_hit_rate, device_pinned_bytes, and the
    h2d/d2h_saved transport counters) once a serve process has
    configured serve/residency.py."""
    if registry is None:
        registry = mod_metrics.global_registry()
    if counters is not None:
        mod_metrics.refresh_device_gauges(counters, registry)
        mod_metrics.refresh_rollup_gauges(counters, registry)
    doc = {'version': STATS_METRICS_VERSION,
           'counters': {}, 'gauges': {}, 'histograms': {}}
    for name, labels, m in registry.snapshot():
        jname = _json_name(name, labels)
        if m.kind == mod_metrics.COUNTER:
            doc['counters'][jname] = m.value
        elif m.kind == mod_metrics.GAUGE:
            doc['gauges'][jname] = round(m.value, 6)
        else:
            cum = 0
            buckets = {}
            for i, b in enumerate(m.bounds):
                cum += m.counts[i]
                buckets['%g' % b] = cum
            buckets['+Inf'] = m.total
            ent = {'count': m.total, 'sum': round(m.sum, 3),
                   'buckets': buckets}
            for label, q in QUANTILES:
                v = m.quantile(q)
                ent[label] = round(v, 3) if v is not None else None
            doc['histograms'][jname] = ent
    return doc


def histogram_from_doc(ent):
    """Re-hydrate a Histogram from the /stats JSON shape
    stats_section renders (count/sum + CUMULATIVE buckets) — the
    fleet aggregator's input: member histograms travel as their
    /stats documents and merge through the existing Histogram.merge.
    Returns None for a malformed document (a fleet view must degrade,
    never crash, on one member's bad bytes)."""
    try:
        buckets = ent['buckets']
        bounds = sorted(float(k) for k in buckets if k != '+Inf')
        h = mod_metrics.Histogram(tuple(bounds))
        cum = 0
        for i, b in enumerate(bounds):
            c = int(buckets['%g' % b])
            h.counts[i] = c - cum
            cum = c
        h.total = int(ent['count'])
        h.counts[len(bounds)] = h.total - cum
        h.sum = float(ent['sum'])
        if h.total < 0 or any(c < 0 for c in h.counts):
            return None
        return h
    except (KeyError, TypeError, ValueError):
        return None


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == '_' else '_')
    name = ''.join(out)
    if name and name[0].isdigit():
        name = '_' + name
    return 'dn_' + name


def _prom_labels(labels, extra=None):
    pairs = list(labels) + (extra or [])
    if not pairs:
        return ''
    body = ','.join('%s="%s"' % (k, str(v).replace('\\', '\\\\')
                                 .replace('"', '\\"'))
                    for k, v in pairs)
    return '{%s}' % body


def _fmt(v):
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return '%d' % int(v)
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(registry=None, counters=None):
    """Render the registry as Prometheus text exposition."""
    if registry is None:
        registry = mod_metrics.global_registry()
    if counters is not None:
        mod_metrics.refresh_device_gauges(counters, registry)
        mod_metrics.refresh_rollup_gauges(counters, registry)
    lines = []
    typed = set()
    for name, labels, m in registry.snapshot():
        pname = _prom_name(name)
        if m.kind == mod_metrics.HISTOGRAM:
            if pname not in typed:
                typed.add(pname)
                lines.append('# TYPE %s histogram' % pname)
            cum = 0
            for i, b in enumerate(m.bounds):
                cum += m.counts[i]
                lines.append('%s_bucket%s %d' % (
                    pname, _prom_labels(labels, [('le', '%g' % b)]),
                    cum))
            lines.append('%s_bucket%s %d' % (
                pname, _prom_labels(labels, [('le', '+Inf')]),
                m.total))
            lines.append('%s_sum%s %s' % (pname, _prom_labels(labels),
                                          _fmt(m.sum)))
            lines.append('%s_count%s %d' % (pname,
                                            _prom_labels(labels),
                                            m.total))
        else:
            kind = 'counter' if m.kind == mod_metrics.COUNTER \
                else 'gauge'
            if pname not in typed:
                typed.add(pname)
                lines.append('# TYPE %s %s' % (pname, kind))
            lines.append('%s%s %s' % (pname, _prom_labels(labels),
                                      _fmt(m.value)))
    return '\n'.join(lines) + '\n' if lines else ''
