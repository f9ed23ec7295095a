"""`dn top`: a live terminal operator console over the fleet view.

Counterpart of dragnet_tpu/serve/top.py (whole).
Plain ANSI redraw — no curses, no new dependencies: each frame homes
the cursor (ESC[H), draws the fleet header (epoch, members
up/draining/unreachable, qps, p50/p95, shed rate), the per-member
table, and the scrolling event tail, clearing to end-of-screen
(ESC[J) so shrinking frames leave no stale rows.  Polls the
``fleet_stats`` op at DN_TOP_INTERVAL_MS; a server that is not a
cluster member answers with a one-member fleet of itself, so the
console degrades to single-process mode against a bare `--remote`
socket with no mode switch.

A fetch failure paints an error banner and keeps polling (the server
coming back mid-incident is exactly when the operator is watching);
Ctrl-C exits cleanly.  `--once` renders a single frame with no ANSI
control codes — the scriptable/testable path.
"""

import json
import sys
import time

from ..errors import DNError

HOME = '\x1b[H'
CLEAR_TO_END = '\x1b[J'
BOLD, DIM, RESET = '\x1b[1m', '\x1b[2m', '\x1b[0m'

EVENT_TAIL_ROWS = 12


def _fmt(v, unit='', none='-'):
    if v is None:
        return none
    if isinstance(v, float):
        return ('%.1f%s' if v >= 10 else '%.2f%s') % (v, unit)
    return '%s%s' % (v, unit)


def _fmt_bytes(v, none='-'):
    if v is None:
        return none
    v = float(v)
    for unit in ('B', 'KB', 'MB', 'GB'):
        if v < 1024 or unit == 'GB':
            return ('%d%s' % (v, unit)) if unit == 'B' \
                else ('%.1f%s' % (v, unit))
        v /= 1024.0
    return none


def _member_state(row):
    if not row.get('ok'):
        return 'DOWN'
    if row.get('leaving'):
        return 'leaving'
    if row.get('draining'):
        return 'draining'
    if row.get('degraded_ro'):
        return 'read-only'       # disk critical: still serving reads
    if row.get('pending_epoch'):
        return 'handoff'
    if row.get('disk_mode') == 'low':
        return 'disk-low'
    return 'up'


def render_frame(doc, ansi=True):
    """The full frame for one fleet document; returns the string
    (render and transport separated so tests pin the layout without a
    terminal)."""
    b, d, r = (BOLD, DIM, RESET) if ansi else ('', '', '')
    lines = []
    agg = doc.get('aggregate') or {}
    lat = agg.get('latency') or {}
    when = time.strftime('%H:%M:%S',
                         time.localtime(doc.get('ts') or time.time()))
    epoch = doc.get('epoch')
    head = ('%sdn top%s  %s  epoch %s  members %d/%d up'
            % (b, r, when, epoch if epoch is not None else '-',
               doc.get('members_up', 0), doc.get('members_total', 0)))
    if doc.get('members_draining'):
        head += '  (%d draining)' % doc['members_draining']
    if doc.get('unreachable'):
        head += '  %sUNREACHABLE: %s%s' \
            % (b, ','.join(doc['unreachable']), r)
    if doc.get('epoch_skew'):
        head += '  %sepoch skew %d%s' % (b, doc['epoch_skew'], r)
    lines.append(head)
    lines.append(
        'qps %s  p50 %s  p95 %s  p99 %s  shed/s %s  requests %s  '
        'errors %s'
        % (_fmt(agg.get('qps_1m')), _fmt(lat.get('p50'), 'ms'),
           _fmt(lat.get('p95'), 'ms'), _fmt(lat.get('p99'), 'ms'),
           _fmt(agg.get('shed_rate_1m')), _fmt(agg.get('requests')),
           _fmt(agg.get('errors'))))
    rp = doc.get('repair') or {}
    if rp.get('queued') or rp.get('completed') or rp.get('failed'):
        lines.append('repair queued %d completed %d failed %d'
                     % (rp.get('queued', 0), rp.get('completed', 0),
                        rp.get('failed', 0)))
    # repeat-traffic line: only when some member runs a cache or a
    # maintenance timer (bare fleets keep the old frame byte-for-byte)
    if agg.get('cache_hit_rate') is not None or \
            agg.get('compact_backlog') is not None or \
            agg.get('rollup_coverage'):
        lines.append(
            'cache hit %s  rollup cov %s  compact backlog %s'
            % (_fmt(agg.get('cache_hit_rate')),
               _fmt(agg.get('rollup_coverage')),
               _fmt(agg.get('compact_backlog'))))
    # device-lane line: only when some member runs HBM residency
    # (host-only fleets keep the old frame byte-for-byte)
    if agg.get('device_residency_hit_rate') is not None or \
            agg.get('device_pinned_bytes') is not None:
        dev = ('device resid hit %s  pinned %s'
               % (_fmt(agg.get('device_residency_hit_rate')),
                  _fmt_bytes(agg.get('device_pinned_bytes'))))
        # index-query offload column: only once some member's device
        # index lane has dispatched (idle lanes keep the line short)
        if agg.get('index_device_dispatches') is not None:
            dev += ('  iq disp %s  sh/disp %s  h2d saved %s'
                    % (_fmt(agg.get('index_device_dispatches')),
                       _fmt(agg.get(
                           'index_device_shards_per_dispatch')),
                       _fmt_bytes(agg.get(
                           'index_device_h2d_saved_bytes'))))
        lines.append(dev)
    if doc.get('members_read_only'):
        lines.append('%sDISK: %d member(s) read-only (min free %s%%)'
                     '%s'
                     % (b, doc['members_read_only'],
                        _fmt(doc.get('min_disk_free_pct')), r))
    elif doc.get('min_disk_free_pct') is not None and \
            doc['min_disk_free_pct'] < 15:
        lines.append('disk: min free %s%%'
                     % _fmt(doc['min_disk_free_pct']))
    lines.append('')

    cols = ('member', 'state', 'epoch', 'qps', 'p50', 'p95',
            'inflight', 'shed', 'repair', 'lag', 'cache', 'backlog')
    widths = [11, 9, 7, 8, 9, 9, 10, 7, 7, 9, 7, 8]
    lines.append(d + ''.join(c.ljust(w)
                             for c, w in zip(cols, widths)) + r)
    breakers = doc.get('breakers') or {}
    for name in sorted((doc.get('members') or {})):
        row = doc['members'][name]
        state = _member_state(row)
        br = breakers.get(name) or {}
        if row.get('ok') and br.get('state') not in (None, 'closed'):
            state += '!'          # this router's breaker is not closed
        ep = row.get('epoch')
        if row.get('pending_epoch'):
            ep = '%s>%s' % (ep, row['pending_epoch'])
        vals = (
            name, state,
            _fmt(ep), _fmt(row.get('qps_1m')),
            _fmt(row.get('p50_ms'), 'ms'),
            _fmt(row.get('p95_ms'), 'ms'),
            '%s/%s' % (row.get('inflight', '-'),
                       row.get('queued', '-'))
            if row.get('ok') else '-',
            _fmt(row.get('shed')), _fmt(row.get('repair_queued')),
            _fmt(row.get('ingest_lag_ms'), 'ms'),
            _fmt(row.get('cache_hit_rate')),
            _fmt(row.get('compact_backlog')))
        line = ''.join(str(v).ljust(w)
                       for v, w in zip(vals, widths))
        lines.append(line)
    lines.append('')

    events = doc.get('events') or []
    if events:
        lines.append(d + 'events' + r)
        for e in events[-EVENT_TAIL_ROWS:]:
            ets = time.strftime(
                '%H:%M:%S', time.localtime(e.get('ts') or 0))
            attrs = {k: v for k, v in e.items()
                     if k not in ('ts', 'seq', 'type', 'member',
                                  'trace')}
            detail = ' '.join('%s=%s' % (k, v)
                              for k, v in sorted(attrs.items()))
            lines.append(('%s %-10s %-22s %s'
                          % (ets, e.get('member') or '-',
                             e.get('type') or '?', detail))[:118])
    elif doc.get('members') and not any(
            m.get('events') for m in doc['members'].values()
            if m.get('ok')):
        lines.append(d + 'events: journal disabled on every member '
                     '(set DN_EVENTS / DN_EVENTS_FILE)' + r)
    return '\n'.join(lines) + '\n'


def fetch_fleet(remote, timeout_s=30.0, events_limit=None):
    """One fleet_stats fetch; raises DNError on failure."""
    from . import client as mod_client
    req = {'op': 'fleet_stats'}
    if events_limit is not None:
        req['events'] = events_limit
    rc, header, out, err = mod_client.request_bytes(
        remote, req, timeout_s=timeout_s)
    if rc != 0:
        raise DNError(err.decode('utf-8', 'replace').strip()
                      or 'fleet_stats failed')
    try:
        return json.loads(out.decode('utf-8'))
    except ValueError as e:
        raise DNError('malformed fleet_stats response',
                      cause=DNError(str(e)))


def _top_subscribed(remote, interval_ms, once, out):
    """The push-path console (`dn top --subscribe`): one standing
    fleet subscription, frames arriving as the server publishes them
    — no re-poll, no per-refresh aggregation server-side.  Returns an
    exit code, or None when the endpoint cannot push (a v1 or
    pre-push server) and the caller should fall back to polling.  A
    mid-stream transport cut reconnects with the resume token; the
    server recognizing the token skips the re-seed."""
    from . import client as mod_client
    req = {'op': 'subscribe', 'watch': 'fleet',
           'interval_ms': max(100, int(interval_ms))}
    resume = None
    first = True
    failures = 0
    while True:
        stream = None
        try:
            stream = mod_client.subscribe_stream(remote, dict(req),
                                                 resume=resume)
            for fr in stream:
                failures = 0
                resume = (fr['token'], fr['payload'])
                doc = json.loads(fr['payload'].decode('utf-8'))
                if once:
                    out.write(render_frame(doc, ansi=False))
                    out.flush()
                    return 0
                frame = HOME + render_frame(doc, ansi=True) + \
                    CLEAR_TO_END
                if first:
                    frame = '\x1b[2J' + frame
                    first = False
                try:
                    out.write(frame)
                    out.flush()
                except (BrokenPipeError, OSError):
                    return 0
            # clean 'end' frame (server draining): reconnect and
            # keep watching — the replacement coming up is exactly
            # when the operator is looking
            time.sleep(interval_ms / 1000.0)
        except mod_client.SubscribeUnsupported:
            return None
        except KeyboardInterrupt:
            out.write('\n')
            return 0
        except (DNError, OSError, ValueError) as e:
            failures += 1
            if once or failures > 5:
                sys.stderr.write('dn: fleet subscription failed: '
                                 '%s\n' % getattr(e, 'message', e))
                return 1
            try:
                time.sleep(interval_ms / 1000.0)
            except KeyboardInterrupt:
                out.write('\n')
                return 0
        finally:
            if stream is not None:
                stream.close()


def top_main(remote, interval_ms, once=False, out=None,
             subscribe=False):
    """The console loop; returns the exit code.  `once` renders one
    frame without ANSI control codes and exits.  `subscribe` rides
    the push path (serve/subscribe.py) and falls back to polling —
    with a one-line notice — against servers that cannot push."""
    if out is None:
        out = sys.stdout
    if subscribe:
        rc = _top_subscribed(remote, interval_ms, once, out)
        if rc is not None:
            return rc
        sys.stderr.write('dn: server does not support subscriptions;'
                         ' falling back to polling\n')
    first = True
    while True:
        banner = None
        try:
            doc = fetch_fleet(remote,
                              timeout_s=max(30.0,
                                            interval_ms / 1000.0))
        except (DNError, OSError, ValueError) as e:
            if once:
                sys.stderr.write('dn: fleet fetch failed: %s\n'
                                 % getattr(e, 'message', e))
                return 1
            doc = None
            banner = ('fleet fetch failed: %s (retrying)'
                      % getattr(e, 'message', e))
        if once:
            out.write(render_frame(doc, ansi=False))
            out.flush()
            return 0
        frame = HOME
        if doc is not None:
            frame += render_frame(doc, ansi=True)
        else:
            frame += '%sdn top%s  %s\n' % (BOLD, RESET, banner)
        frame += CLEAR_TO_END
        if first:
            # one full clear on entry so prior shell output does not
            # bleed through between frames
            frame = '\x1b[2J' + frame
            first = False
        try:
            out.write(frame)
            out.flush()
        except (BrokenPipeError, OSError):
            return 0
        try:
            time.sleep(interval_ms / 1000.0)
        except KeyboardInterrupt:
            out.write('\n')
            return 0
