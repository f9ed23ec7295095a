"""Fleet aggregation: one merged observability document for a whole
`dn serve` cluster.

Counterpart of dragnet_tpu/serve/fleet.py (whole).  A cluster member
fetches every member of its topology; a server outside any cluster
answers with the one-member fleet of itself.  The device rows read
the port's /stats `device` section (serve/residency.py and
device_index.stats_doc).

With per-process observability alone, an operator watching a
5-member handoff under flood polls five /stats endpoints by hand and
does the merging in their head.  The ``fleet_stats`` op
fixes that: ANY member (or a bare single-process server) scatters
``stats`` — and, when asked, ``events`` — to every topology member
over the pooled v2 path and merges one fleet document:

* aggregate latency quantiles — member ``serve_op_latency_ms``
  histograms re-hydrated from their /stats JSON and folded through
  the existing ``Histogram.merge`` (the same merge the registry
  uses), so fleet p50/p95 are computed over the REAL distribution,
  never averaged quantiles;
* fleet qps / shed-rate trends when members run history rings
  (DN_METRICS_HISTORY_S), summed across members per window;
* an epoch-skew table (committed + pending epoch per member — the
  first thing to look at during a reconfiguration);
* the aggregating member's breaker/draining view of everyone, plus
  each member's own draining flag;
* per-tenant fairness counters summed across members;
* repair and handoff backlogs, ingest lag per follow source, and the
  merged event tail (each entry tagged with its member).

Failure posture — the whole point of a fleet view under an incident:
every member fetch is bounded by ``fleet_timeout_s`` and runs on its
own thread; a dead member shows up as ``ok: false`` with the error
string in its slot and its name in ``unreachable``.  The view NEVER
hangs on a dead member and NEVER presents a partial doc as complete
(``complete`` is true only when every member answered).

A server with no cluster degrades to a one-member fleet of itself —
`dn top` against a bare socket renders single-process mode through
the identical document shape.
"""

import json
import threading
import time

from ..obs import events as obs_events
from ..obs import export as obs_export

FLEET_VERSION = 1

# the latency family the aggregate quantiles merge over
LATENCY_METRIC = 'serve_op_latency_ms'

# default per-member fetch bound; config.obs_config validates the
# DN_FLEET_TIMEOUT_S override
DEFAULT_TIMEOUT_S = 5


def _member_row(name, st, latency=None):
    """The trimmed per-member table row the fleet doc carries (the
    full /stats docs would make the fleet doc unbounded).  `latency`
    is the member's pre-merged op histogram (merge_fleet computes it
    once and shares it with the aggregate)."""
    reqs = st.get('requests') or {}
    infl = st.get('inflight') or {}
    topo = st.get('topology') or {}
    integ = st.get('integrity') or {}
    repair = integ.get('repair') or {}
    hist = st.get('history') or {}
    row = {
        'ok': True,
        'pid': st.get('pid'),
        'uptime_s': st.get('uptime_s'),
        'draining': bool(st.get('draining')),
        'requests': reqs.get('requests', 0),
        'errors': reqs.get('errors', 0),
        'shed': (reqs.get('shed_overloaded', 0) +
                 reqs.get('busy_rejected', 0)),
        'inflight': infl.get('active', 0),
        'queued': infl.get('queued', 0),
        'epoch': topo.get('epoch'),
        'pending_epoch': topo.get('pending_epoch'),
        'leaving': topo.get('leaving'),
        'verify': integ.get('verify'),
        'repair_queued': repair.get('queued', 0),
        'repair_completed': repair.get('completed', 0),
        'repair_failed': repair.get('failed', 0),
        'history': bool(hist.get('enabled')),
        'events': bool((st.get('events') or {}).get('enabled')),
    }
    # repeat-traffic economics: result-cache hit rate, rollup
    # coverage, and the compaction backlog per member
    rcache = ((st.get('caches') or {}).get('results')) or {}
    if rcache.get('enabled'):
        row['cache_hit_rate'] = rcache.get('hit_rate')
    # device-lane serving: HBM residency per member (absent rows mean
    # the member never configured it — honest absence, like the
    # result cache)
    resid = ((st.get('device') or {}).get('residency')) or {}
    if resid.get('enabled'):
        row['device_residency_hit_rate'] = resid.get('hit_rate')
        row['device_pinned_bytes'] = resid.get('bytes')
    # batched index-query offload: only members whose device lane has
    # actually dispatched report (honest absence, like residency)
    iq = ((st.get('device') or {}).get('index_query')) or {}
    if iq.get('dispatches'):
        row['index_device_dispatches'] = iq.get('dispatches')
        row['index_device_shards_per_dispatch'] = \
            iq.get('shards_per_dispatch')
        row['index_device_h2d_saved_bytes'] = \
            iq.get('h2d_saved_bytes', 0)
    # standing queries: active subscriber count per member (honest
    # absence when the member runs with DN_SUB_MAX=0)
    subs = st.get('subscriptions') or {}
    if subs.get('enabled'):
        row['subscriptions'] = subs.get('active', 0)
    roll = st.get('rollup') or {}
    if roll:
        row['rollup_coverage'] = roll.get('coverage_ratio')
    maint = st.get('maintenance')
    if maint is not None:
        row['compact_backlog'] = maint.get('compact_backlog')
    res = st.get('resources') or {}
    if res:
        # resource governance: the member's disk mode and headroom
        # ride the fleet view — a read-only member is the first thing
        # an operator needs to see during a disk incident
        row['disk_mode'] = res.get('mode')
        row['disk_free_pct'] = res.get('free_pct')
        row['degraded_ro'] = bool(res.get('read_only'))
    # per-member latency: this member's own op histograms merged
    if latency is not None and latency.total:
        row['p50_ms'] = round(latency.quantile(0.50), 3)
        row['p95_ms'] = round(latency.quantile(0.95), 3)
    # per-member qps / shed trends from its history rings
    rates = _member_rates(st)
    row.update(rates)
    fl = st.get('follow')
    if fl is not None:
        row['ingest_lag_ms'] = fl.get('ingest_lag_ms')
    return row


def _merged_latency(st):
    """One Histogram folding every serve_op_latency_ms{op=*} entry in
    a member's /stats metrics section; None when absent."""
    hists = ((st.get('metrics') or {}).get('histograms')) or {}
    merged = None
    for jname, ent in hists.items():
        if jname != LATENCY_METRIC and \
                not jname.startswith(LATENCY_METRIC + '{'):
            continue
        h = obs_export.histogram_from_doc(ent)
        if h is None:
            continue
        if merged is None:
            merged = h
        else:
            merged.merge(h)
    return merged


def _member_rates(st):
    """qps_1m / shed_1m for one member from its history section
    (None values when history is off or too young — honest, never
    fabricated)."""
    series = ((st.get('history') or {}).get('series')) or {}
    qps = None
    shed = None
    for jname, doc in series.items():
        if (jname == LATENCY_METRIC + ':count' or
                (jname.startswith(LATENCY_METRIC + '{') and
                 jname.endswith(':count'))):
            r = doc.get('rate_1m')
            if r is not None:
                qps = (qps or 0.0) + r
        elif jname.startswith('serve_shed_total'):
            r = doc.get('rate_1m')
            if r is not None:
                shed = (shed or 0.0) + r
    return {'qps_1m': round(qps, 3) if qps is not None else None,
            'shed_1m': round(shed, 3) if shed is not None else None}


def _fetch_member(endpoint, timeout_s, events_limit):
    """(stats_doc, events_list_or_None) from one remote member over
    the pooled path; raises on any failure (the caller owns the error
    slot)."""
    from . import client as mod_client
    rc, header, out, err = mod_client.request_bytes(
        endpoint, {'op': 'stats'}, timeout_s=timeout_s, pooled=True)
    if rc != 0:
        raise ValueError(err.decode('utf-8', 'replace').strip()
                         or 'stats op failed')
    st = json.loads(out.decode('utf-8'))
    events = None
    if events_limit:
        rc, header, out, err = mod_client.request_bytes(
            endpoint, {'op': 'events', 'limit': events_limit},
            timeout_s=timeout_s, pooled=True)
        if rc == 0:
            events = (json.loads(out.decode('utf-8'))
                      .get('events')) or []
    return st, events


def fleet_doc(server, timeout_s=None, events_limit=50):
    """The merged fleet document (the ``fleet_stats`` op body).  Any
    member aggregates; `server` is the local DnServer whose own stats
    are read in-process (a member never dials itself)."""
    if timeout_s is None:
        timeout_s = server.conf.get('fleet_timeout_s',
                                    DEFAULT_TIMEOUT_S)
    topo = server.cluster
    if topo is not None:
        names = sorted(topo.member_names())
        endpoints = {n: topo.endpoint(n) for n in names}
    else:
        # bare single-process server: a one-member fleet of itself
        names = [server.member or 'local']
        endpoints = {}

    stats = {}
    events = {}
    errors = {}
    threads = []
    lock = threading.Lock()

    def fetch(name):
        try:
            st, ev = _fetch_member(endpoints[name], timeout_s,
                                   events_limit)
            with lock:
                stats[name] = st
                if ev is not None:
                    events[name] = ev
        except Exception as e:
            with lock:
                errors[name] = str(e)

    self_name = server.member if server.member is not None \
        else names[0]
    for name in names:
        if name == self_name:
            continue
        t = threading.Thread(target=fetch, args=(name,),
                             daemon=True,
                             name='dn-fleet-%s' % name)
        threads.append(t)
        t.start()
    # the local member answers in-process while the others fetch
    stats[self_name] = server.stats_doc()
    j = obs_events.journal()
    if j is not None and events_limit:
        events[self_name] = j.tail(limit=events_limit)
    deadline = time.monotonic() + timeout_s + 1.0
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            # the fetch thread is wedged past its own timeout: the
            # member gets an error slot NOW — the view never hangs
            with lock:
                errors.setdefault(t.name.split('dn-fleet-', 1)[-1],
                                  'fleet fetch timed out')
    # snapshot under the lock: a wedged fetch thread that completes
    # AFTER its deadline slot must not mutate the dicts mid-merge
    with lock:
        stats = dict(stats)
        events = {n: list(v) for n, v in events.items()}
        errors = dict(errors)
    return merge_fleet(server, names, stats, events, errors,
                       timeout_s=timeout_s)


def merge_fleet(server, names, stats, events, errors, timeout_s=None):
    """Fold per-member stats/events/errors into the fleet document
    (split from fleet_doc so tests can merge canned inputs)."""
    topo = server.cluster
    members = {}
    epochs = {}
    agg_latency = None
    qps = None
    shed_rate = None
    totals = {'requests': 0, 'errors': 0, 'shed': 0}
    tenants = {}
    repair = {'scheduled': 0, 'completed': 0, 'failed': 0,
              'queued': 0}
    handoff = {}
    follow = {}
    cache_hits = cache_misses = 0
    cache_on = False
    resid_hits = resid_misses = resid_pinned = 0
    resid_on = False
    iq_dispatches = iq_shards = iq_pin_hits = iq_saved = 0
    iq_on = False
    roll_covered = roll_queried = 0
    compact_backlog = None
    sub_active = sub_pushes = 0
    sub_on = False
    for name in names:
        st = stats.get(name)
        if st is None:
            members[name] = {'ok': False, 'unreachable': True,
                             'error': errors.get(name, 'no response')}
            continue
        h = _merged_latency(st)
        row = _member_row(name, st, latency=h)
        members[name] = row
        for k in totals:
            totals[k] += row.get(k) or 0
        if row.get('qps_1m') is not None:
            qps = (qps or 0.0) + row['qps_1m']
        if row.get('shed_1m') is not None:
            shed_rate = (shed_rate or 0.0) + row['shed_1m']
        if h is not None:
            if agg_latency is None:
                agg_latency = h
            else:
                agg_latency.merge(h)
        tp = st.get('topology') or {}
        if tp.get('configured'):
            epochs[name] = {'epoch': tp.get('epoch'),
                            'pending_epoch': tp.get('pending_epoch'),
                            'state': tp.get('state')}
            if tp.get('handoff') is not None:
                handoff[name] = tp['handoff']
        for tname, tdoc in (((st.get('tenants') or {})
                             .get('tenants')) or {}).items():
            agg = tenants.setdefault(
                tname, {'requests': 0, 'admitted': 0,
                        'rejected_busy': 0, 'shed_overload': 0,
                        'completed': 0, 'queued': 0})
            for k in agg:
                agg[k] += tdoc.get(k, 0)
        rp = ((st.get('integrity') or {}).get('repair')) or {}
        for k in repair:
            repair[k] += rp.get(k, 0)
        rc = ((st.get('caches') or {}).get('results')) or {}
        if rc.get('enabled'):
            cache_on = True
            cache_hits += rc.get('hits', 0) or 0
            cache_misses += rc.get('misses', 0) or 0
        rd = ((st.get('device') or {}).get('residency')) or {}
        if rd.get('enabled'):
            resid_on = True
            resid_hits += rd.get('hits', 0) or 0
            resid_misses += rd.get('misses', 0) or 0
            resid_pinned += rd.get('bytes', 0) or 0
        iqd = ((st.get('device') or {}).get('index_query')) or {}
        if iqd.get('dispatches'):
            iq_on = True
            iq_dispatches += iqd.get('dispatches', 0) or 0
            iq_shards += iqd.get('shards', 0) or 0
            iq_pin_hits += iqd.get('pinned_shard_hits', 0) or 0
            iq_saved += iqd.get('h2d_saved_bytes', 0) or 0
        roll = st.get('rollup') or {}
        roll_covered += roll.get('covered_shards', 0) or 0
        roll_queried += roll.get('shards_queried', 0) or 0
        maint = st.get('maintenance')
        if maint is not None:
            compact_backlog = (compact_backlog or 0) + \
                (maint.get('compact_backlog') or 0)
        sb = st.get('subscriptions') or {}
        if sb.get('enabled'):
            sub_on = True
            sub_active += sb.get('active', 0) or 0
            sub_pushes += ((sb.get('counters') or {})
                           .get('pushes', 0)) or 0
        fl = st.get('follow')
        if fl is not None:
            follow[name] = {'ingest_lag_ms': fl.get('ingest_lag_ms'),
                            'sources': len(fl.get('sources') or [])}

    # the aggregating member's router view: breaker state + draining
    # per member (how THIS router would dispatch right now)
    breakers = {}
    if server.router is not None:
        for name, snap in (server.router.stats_doc()
                           .get('members') or {}).items():
            breakers[name] = {'state': snap.get('state'),
                              'draining': snap.get('draining'),
                              'last_ok_age_s':
                              snap.get('last_ok_age_s')}

    # merged event tail: every member's entries, member-tagged,
    # ordered by wall time (tie-broken by seq).  Deduped on the full
    # entry identity (member tag, seq, ts, type): embedded
    # same-process members (tests, soaks) share one journal and would
    # otherwise report each entry once per member — while two
    # DISTINCT processes whose journals happen to reuse a seq (e.g.
    # routers a and c both emitting breaker.open member=b as entry 7)
    # differ in ts and both survive.
    tail = []
    seen = set()
    for name, evs in events.items():
        for e in evs:
            if 'member' not in e or e['member'] is None:
                e = dict(e, member=name)
            key = (e.get('member'), e.get('seq'), e.get('ts'),
                   e.get('type'))
            if key in seen:
                continue
            seen.add(key)
            tail.append(e)
    tail.sort(key=lambda e: (e.get('ts') or 0, e.get('seq') or 0))

    up = [n for n in names if stats.get(n) is not None]
    unreachable = [n for n in names if n not in stats]
    known_epochs = [d['epoch'] for d in epochs.values()
                    if isinstance(d.get('epoch'), int)]
    aggregate = {
        'requests': totals['requests'],
        'errors': totals['errors'],
        'shed': totals['shed'],
        'qps_1m': round(qps, 3) if qps is not None else None,
        'shed_rate_1m': round(shed_rate, 3)
        if shed_rate is not None else None,
        # fleet repeat-traffic economics: hit rate over SUMMED member
        # hits/misses (never averaged rates), rollup coverage over
        # summed shard counts, total compaction backlog (None when no
        # member runs a cache / maintenance timer — honest absence)
        'cache_hit_rate': round(
            cache_hits / (cache_hits + cache_misses), 4)
        if cache_on and (cache_hits + cache_misses) else
        (0.0 if cache_on else None),
        'rollup_coverage': round(roll_covered / roll_queried, 4)
        if roll_queried else 0.0,
        'compact_backlog': compact_backlog,
        # device-lane serving: HBM residency over SUMMED member
        # hits/misses + total pinned bytes (None when no member
        # configured residency — honest absence, like the cache)
        'device_residency_hit_rate': round(
            resid_hits / (resid_hits + resid_misses), 4)
        if resid_on and (resid_hits + resid_misses) else
        (0.0 if resid_on else None),
        'device_pinned_bytes': resid_pinned if resid_on else None,
        # batched index-query offload: SUMMED dispatch/shard counts
        # and pinned-shard H2D savings (None when no member's device
        # index lane has engaged — honest absence)
        'index_device_dispatches': iq_dispatches if iq_on else None,
        'index_device_shards_per_dispatch': round(
            iq_shards / iq_dispatches, 2)
        if iq_on and iq_dispatches else (0.0 if iq_on else None),
        'index_device_pinned_shard_hits':
        iq_pin_hits if iq_on else None,
        'index_device_h2d_saved_bytes': iq_saved if iq_on else None,
        # standing queries: SUMMED active subscribers and lifetime
        # pushes (None when no member enables subscriptions —
        # honest absence)
        'subscriptions': sub_active if sub_on else None,
        'subscription_pushes': sub_pushes if sub_on else None,
    }
    if agg_latency is not None and agg_latency.total:
        aggregate['latency'] = {
            'count': agg_latency.total,
            'p50': round(agg_latency.quantile(0.50), 3),
            'p95': round(agg_latency.quantile(0.95), 3),
            'p99': round(agg_latency.quantile(0.99), 3),
        }
    else:
        aggregate['latency'] = None
    doc = {
        'version': FLEET_VERSION,
        'ts': round(time.time(), 3),
        'aggregated_by': server.member,
        'epoch': topo.epoch if topo is not None else None,
        'epoch_skew': (max(known_epochs) - min(known_epochs))
        if known_epochs else 0,
        'members_total': len(names),
        'members_up': len(up),
        'members_draining': sum(
            1 for n in up if members[n].get('draining') or
            members[n].get('leaving')),
        # disk governance rollup: read-only members and the fleet's
        # tightest free-space margin (None when no member reports)
        'members_read_only': sum(
            1 for n in up if members[n].get('degraded_ro')),
        'min_disk_free_pct': min(
            (members[n]['disk_free_pct'] for n in up
             if members[n].get('disk_free_pct') is not None),
            default=None),
        'unreachable': unreachable,
        'complete': not unreachable,
        'fetch_timeout_s': timeout_s,
        'aggregate': aggregate,
        'members': members,
        'epochs': epochs,
        'breakers': breakers,
        'tenants': tenants,
        'repair': repair,
        'handoff': handoff,
        'follow': follow,
        'events': tail,
    }
    return doc


def fleet_prometheus_text(doc):
    """Render the fleet document's headline numbers as Prometheus
    text (`dn stats --cluster --prom`): a synthesized dn_fleet_*
    family — member liveness, aggregate throughput/latency, repair
    backlog — for scrapers that want the merged view without N
    per-member scrape targets."""
    from ..obs import metrics as mod_metrics
    reg = mod_metrics.Registry()
    reg.set_gauge('fleet_members_total', doc['members_total'])
    reg.set_gauge('fleet_members_up', doc['members_up'])
    reg.set_gauge('fleet_members_draining', doc['members_draining'])
    reg.set_gauge('fleet_members_unreachable',
                  len(doc['unreachable']))
    reg.set_gauge('fleet_epoch_skew', doc['epoch_skew'])
    reg.set_gauge('fleet_members_read_only',
                  doc.get('members_read_only') or 0)
    if doc.get('min_disk_free_pct') is not None:
        reg.set_gauge('fleet_min_disk_free_pct',
                      doc['min_disk_free_pct'])
    if doc.get('epoch') is not None:
        reg.set_gauge('fleet_epoch', doc['epoch'])
    agg = doc['aggregate']
    reg.inc('fleet_requests_total', agg['requests'])
    reg.inc('fleet_errors_total', agg['errors'])
    reg.inc('fleet_shed_total', agg['shed'])
    if agg.get('qps_1m') is not None:
        reg.set_gauge('fleet_qps_1m', agg['qps_1m'])
    if agg.get('cache_hit_rate') is not None:
        reg.set_gauge('fleet_cache_hit_rate', agg['cache_hit_rate'])
    if agg.get('rollup_coverage') is not None:
        reg.set_gauge('fleet_rollup_coverage', agg['rollup_coverage'])
    if agg.get('compact_backlog') is not None:
        reg.set_gauge('fleet_compact_backlog', agg['compact_backlog'])
    if agg.get('device_residency_hit_rate') is not None:
        reg.set_gauge('fleet_device_residency_hit_rate',
                      agg['device_residency_hit_rate'])
    if agg.get('device_pinned_bytes') is not None:
        reg.set_gauge('fleet_device_pinned_bytes',
                      agg['device_pinned_bytes'])
    if agg.get('index_device_dispatches') is not None:
        reg.set_gauge('fleet_index_device_dispatches',
                      agg['index_device_dispatches'])
    if agg.get('index_device_h2d_saved_bytes') is not None:
        reg.set_gauge('fleet_index_device_h2d_saved_bytes',
                      agg['index_device_h2d_saved_bytes'])
    if agg.get('subscriptions') is not None:
        reg.set_gauge('fleet_subscriptions', agg['subscriptions'])
    if agg.get('subscription_pushes') is not None:
        reg.inc('fleet_subscription_pushes_total',
                agg['subscription_pushes'])
    lat = agg.get('latency')
    if lat:
        reg.set_gauge('fleet_latency_p50_ms', lat['p50'])
        reg.set_gauge('fleet_latency_p95_ms', lat['p95'])
        reg.set_gauge('fleet_latency_p99_ms', lat['p99'])
    rp = doc['repair']
    reg.set_gauge('fleet_repair_queued', rp['queued'])
    reg.inc('fleet_repair_completed_total', rp['completed'])
    reg.inc('fleet_repair_failed_total', rp['failed'])
    for name, row in doc['members'].items():
        reg.set_gauge('fleet_member_up',
                      1.0 if row.get('ok') else 0.0, member=name)
    return obs_export.prometheus_text(reg)
