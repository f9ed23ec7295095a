"""The static cluster map for scatter-gather serving.

Counterpart (a copy) of dragnet_tpu/serve/topology.py.  Host code.

A topology file describes a `dn serve` cluster: its members (name ->
endpoint), its partitions (each a replica set of members), the shard
assignment rule, and an epoch.  Every member loads the SAME file
(`dn serve --cluster=TOPOLOGY.json --member=NAME`); any member can act
as router for an incoming query, scattering partition-scoped partial
queries to the owners and merging the partial aggregates
(serve/router.py).

File format (JSON):

    {
      "epoch": 1,
      "assign": "hash",
      "members": {
        "a": {"endpoint": "/run/dn-a.sock"},
        "b": {"endpoint": "10.0.0.2:9401"},
        "c": {"endpoint": "10.0.0.3:9401"}
      },
      "partitions": [
        {"id": 0, "replicas": ["a", "b"]},
        {"id": 1, "replicas": ["b", "c"]},
        {"id": 2, "replicas": ["c", "a"]}
      ]
    }

* ``epoch`` — integer generation stamp.  Members reject partial
  queries whose epoch differs from their loaded topology (a retryable
  error), so a router and member running different topology files can
  never silently merge mismatched partitions.
* ``assign`` — the shard -> partition rule.  ``hash`` (default):
  crc32 of the shard's file name modulo the partition count — stable
  across processes and runs (never Python's salted hash()).
  ``time-range``: partitions may carry ``after``/``before`` ISO-8601
  bounds; a shard whose filename time-range starts inside a
  partition's window belongs to it, and shards that match no window
  (or carry no parseable time, e.g. an `all`-interval shard) fall
  back to the hash rule.
* ``partitions[].replicas`` — member names in PREFERENCE order: the
  router tries the first live replica, failing over (and hedging) to
  the rest.
* ``members[].endpoint`` — a unix socket path or HOST:PORT, exactly
  the `--remote` address forms (serve/client.parse_addr).
* ``members[].config`` (optional) — a per-member dragnetrc path.  When
  set, THAT member resolves datasources for partial queries and shard
  handoff through its own config instead of the request's, which lets
  each member own a private index tree (the shard-streaming handoff
  fills it).  Omitted in shared-filesystem deployments: every member
  then walks the request's tree (the shared-tree contract).

Dynamic topology (serve/coordinator.py): the same file doubles as the
coordinator source.  A topology may carry ``"state": "pending"`` plus
a ``"prev"`` field embedding the last COMMITTED document; members
polling the file (DN_TOPO_POLL_MS) then serve from ``prev`` while the
new epoch's handoff runs, and cut over atomically when the file is
rewritten as committed (state dropped, prev dropped).
load_topology_state() returns both views; load_topology() keeps the
static single-topology contract (a pending file reads as its
committed ``prev``).

Validation is strict and centralized here (load_topology raises the
shared DNError contract; `dn serve --validate` reports it before any
socket binds): duplicate/overlapping partition ids, replica sets
naming unknown members, empty replica sets, members no partition
uses, overlapping time ranges, and malformed endpoints are all
rejected at load time, not at the first query that meets them.
"""

import json
import os
import zlib

from ..errors import DNError
from .. import jsvalues as jsv

ASSIGN_MODES = ('hash', 'time-range')
STATES = ('committed', 'pending')


class Topology(object):
    """The validated, immutable cluster map."""

    def __init__(self, doc, path=None):
        self.path = path
        self.epoch = doc['epoch']
        self.assign = doc.get('assign') or 'hash'
        self.state = doc.get('state') or 'committed'
        # free-form transition annotation (e.g. the rebalance
        # planner's decisions); surfaced in /stats, never validated
        self.note = doc.get('note')
        self.members = {name: dict(m)
                        for name, m in doc['members'].items()}
        parts = sorted(doc['partitions'], key=lambda p: p['id'])
        self.partitions = [
            {'id': p['id'], 'replicas': list(p['replicas']),
             'after': p.get('after'), 'before': p.get('before'),
             'after_ms': p.get('_after_ms'),
             'before_ms': p.get('_before_ms')}
            for p in parts]
        self._by_id = {p['id']: p for p in self.partitions}

    def partition_ids(self):
        return [p['id'] for p in self.partitions]

    def replicas(self, pid):
        """Member names owning partition `pid`, preference order."""
        return list(self._by_id[pid]['replicas'])

    def endpoint(self, member):
        return self.members[member]['endpoint']

    def member_names(self):
        return sorted(self.members)

    def partitions_of(self, member):
        return [p['id'] for p in self.partitions
                if member in p['replicas']]

    def _hash_partition(self, name):
        idx = zlib.crc32(name.encode('utf-8')) % len(self.partitions)
        return self.partitions[idx]['id']

    def partition_of(self, shard_path, timeformat=None):
        """The partition owning a shard file.  Deterministic from the
        shard's basename (and, in time-range mode, its filename
        time-range), so the router and every member agree without
        coordination."""
        name = os.path.basename(shard_path)
        if self.assign == 'time-range' and timeformat:
            from .. import index_query_mt as mod_iqmt
            rng = mod_iqmt.shard_time_range(name, timeformat)
            if rng is not None:
                start_ms = rng[0]
                for p in self.partitions:
                    after = p['after_ms']
                    before = p['before_ms']
                    if after is None and before is None:
                        continue      # windowless: hash-rule only
                    if (after is None or start_ms >= after) and \
                            (before is None or start_ms < before):
                        return p['id']
        return self._hash_partition(name)

    def member_config(self, member):
        """The member's own dragnetrc path when the topology declares
        one (per-member index trees), else None (shared tree: the
        request's config governs, the shared-tree contract)."""
        m = self.members.get(member)
        return m.get('config') if m else None

    def summary(self):
        """The /stats and --validate view."""
        return {
            'path': self.path,
            'epoch': self.epoch,
            'assign': self.assign,
            'members': {name: m['endpoint']
                        for name, m in self.members.items()},
            'partitions': [{'id': p['id'],
                            'replicas': list(p['replicas'])}
                           for p in self.partitions],
        }

    def doc(self):
        """Re-serialize as a canonical COMMITTED topology document
        (what publish_topology writes; `state`/`prev` never survive a
        round trip — transition framing is the coordinator's job)."""
        partitions = []
        for p in self.partitions:
            ent = {'id': p['id'], 'replicas': list(p['replicas'])}
            if p.get('after') is not None:
                ent['after'] = p['after']
            if p.get('before') is not None:
                ent['before'] = p['before']
            partitions.append(ent)
        return {
            'epoch': self.epoch,
            'assign': self.assign,
            'members': {name: {k: v for k, v in m.items()
                               if k in ('endpoint', 'config')}
                        for name, m in self.members.items()},
            'partitions': partitions,
        }


def _parse_bound(p, key, pid):
    """Validated ISO-8601 (or epoch-seconds) partition bound -> ms."""
    raw = p.get(key)
    if raw is None:
        return None, None
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        return int(raw) * 1000, None
    if isinstance(raw, str):
        ms = jsv.date_parse(raw)
        if ms is not None:
            return ms, None
    return None, ('partition %s: "%s" is not a valid date: %r'
                  % (pid, key, raw))


def validate_doc(doc, _nested=False):
    """First violation of the topology document shape as a string, or
    None; on success the partitions gain parsed _after_ms/_before_ms
    fields (time-range mode).  Transition framing: "state" must be
    'committed' or 'pending'; a pending document must embed its last
    committed predecessor as "prev" (itself a valid committed doc with
    a strictly smaller epoch)."""
    if not isinstance(doc, dict):
        return 'topology is not an object'
    epoch = doc.get('epoch')
    if not isinstance(epoch, int) or isinstance(epoch, bool) or \
            epoch < 1:
        return '"epoch" must be an integer >= 1'
    state = doc.get('state', 'committed')
    if state not in STATES:
        return '"state" must be one of: %s' % ', '.join(STATES)
    prev = doc.get('prev')
    if _nested and (state != 'committed' or prev is not None):
        return '"prev" must be a committed topology without its own ' \
            '"prev"'
    if state == 'pending':
        if prev is None:
            return 'a pending topology must embed its committed ' \
                'predecessor as "prev"'
        err = validate_doc(prev, _nested=True)
        if err is not None:
            return 'prev: %s' % err
        if prev['epoch'] >= epoch:
            return 'pending epoch %d must exceed committed epoch %d' \
                % (epoch, prev['epoch'])
    elif prev is not None:
        return '"prev" is only valid with "state": "pending"'
    assign = doc.get('assign', 'hash')
    if assign not in ASSIGN_MODES:
        return '"assign" must be one of: %s' % ', '.join(ASSIGN_MODES)
    members = doc.get('members')
    if not isinstance(members, dict) or not members:
        return '"members" must be a non-empty object'
    for name, m in members.items():
        if not isinstance(m, dict) or \
                not isinstance(m.get('endpoint'), str) or \
                not m['endpoint']:
            return 'member "%s": "endpoint" must be a non-empty ' \
                'string' % name
        if 'config' in m and (not isinstance(m['config'], str) or
                              not m['config']):
            return 'member "%s": "config" must be a non-empty ' \
                'string when present' % name
    parts = doc.get('partitions')
    if not isinstance(parts, list) or not parts:
        return '"partitions" must be a non-empty array'
    seen_ids = set()
    used = set()
    ranges = []
    for i, p in enumerate(parts):
        if not isinstance(p, dict):
            return 'partitions[%d] is not an object' % i
        pid = p.get('id')
        if not isinstance(pid, int) or isinstance(pid, bool) or \
                pid < 0:
            return 'partitions[%d]: "id" must be an integer >= 0' % i
        if pid in seen_ids:
            return 'partition id %d assigned twice (overlapping ' \
                'partitions)' % pid
        seen_ids.add(pid)
        replicas = p.get('replicas')
        if not isinstance(replicas, list) or not replicas:
            return 'partition %d: "replicas" must be a non-empty ' \
                'array' % pid
        if len(set(replicas)) != len(replicas):
            return 'partition %d: duplicate replica' % pid
        for r in replicas:
            if r not in members:
                return 'partition %d: unknown member "%s"' % (pid, r)
            used.add(r)
        after_ms, err = _parse_bound(p, 'after', pid)
        if err:
            return err
        before_ms, err = _parse_bound(p, 'before', pid)
        if err:
            return err
        if after_ms is not None and before_ms is not None and \
                before_ms <= after_ms:
            return 'partition %d: "before" must be after "after"' \
                % pid
        p['_after_ms'] = after_ms
        p['_before_ms'] = before_ms
        if assign == 'time-range' and \
                (after_ms is not None or before_ms is not None):
            ranges.append((pid, after_ms, before_ms))
    for name in members:
        if name not in used:
            return 'member "%s" owns no partition' % name
    # time ranges must not overlap: two windows both claiming a shard
    # would make partition_of order-dependent
    for i, (pa, aa, ba) in enumerate(ranges):
        for pb, ab, bb in ranges[i + 1:]:
            lo = max(aa if aa is not None else float('-inf'),
                     ab if ab is not None else float('-inf'))
            hi = min(ba if ba is not None else float('inf'),
                     bb if bb is not None else float('inf'))
            if lo < hi:
                return 'partitions %d and %d have overlapping time ' \
                    'ranges' % (pa, pb)
    return None


def load_topology_state(path, member=None):
    """Load + validate a topology file as (committed, pending):
    (Topology, None) for a committed file, (Topology-of-prev,
    Topology-of-new-epoch) for a pending transition file.  Raises
    DNError on any violation, including `member` naming neither a
    committed nor a pending member."""
    try:
        with open(path, 'r') as f:
            raw = f.read()
    except OSError as e:
        raise DNError('cluster topology "%s"' % path,
                      cause=DNError(str(e)))
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise DNError('cluster topology "%s": invalid JSON' % path,
                      cause=DNError(str(e)))
    err = validate_doc(doc)
    if err is not None:
        raise DNError('cluster topology "%s": %s' % (path, err))
    if doc.get('state') == 'pending':
        committed = Topology(doc['prev'], path=path)
        pending = Topology(doc, path=path)
    else:
        committed = Topology(doc, path=path)
        pending = None
    if member is not None and member not in committed.members and \
            (pending is None or member not in pending.members):
        have = set(committed.member_names())
        if pending is not None:
            have |= set(pending.member_names())
        raise DNError('cluster topology "%s": --member "%s" is not a '
                      'member (have: %s)'
                      % (path, member, ', '.join(sorted(have))))
    return committed, pending


def load_topology(path, member=None):
    """Load + validate a topology file; raises DNError on any
    violation (including `member` not naming a member when given).
    A pending transition file reads as its COMMITTED predecessor —
    static consumers (execution plans, `dn serve` startup) serve the
    last committed map until the transition commits."""
    committed, _pending = load_topology_state(path, member=member)
    return committed
