"""The query planner over rollup shards and follow mini-generations.

Counterpart of dragnet_tpu/rollup.py, its query half.  The item stream
a query observes is byte-identical to the plain fine-shard walk:

* **Rollup shards** (`<indexroot>/rollup/<level>/`, built by the
  reference's `dn rollup`) are day-from-hour and month-from-day(-or-hour)
  merges of fine shards with a synthetic `__dn_ts` INTEGER column
  (lquantize at the FINE span) prepended.  Each level carries a
  `.dn_rollup.json` manifest recording exactly which fine files
  (name + mtime_ns + size) each rollup shard was built from; a rollup
  whose recorded sources disagree with the live tree is inert — the
  planner falls back to the fine shards.

* **Mini-generations** (`dn follow --append`) land as
  `<shard>-gNNNNNN` next to their base.  Queries treat the group as ONE
  logical shard (sum-merge by key, then the engines' GROUP BY
  collation order — `index_query_stack.canonical_item_sort` — which
  is exactly what querying the compacted shard emits).

Why the rollup read is byte-identical: the planner rewrites the user
query for a rollup shard by prepending a `__dn_ts` lquantize
breakdown at the fine span (`rollup_query`).  The shard's GROUP BY
emits rows ts-major in the engines' pinned ascending collation, so
slicing on the leading ordinal yields, per fine bucket, exactly the
row set and order the fine shard's own GROUP BY emits.  Bare-SUM
queries (no breakdowns) get one `((), 0)` synthesized per covered fine
shard with no surviving rows, mirroring SQL's `SUM() -> NULL -> 0`
per-shard emission.

Building rollups and compacting generations (`dn rollup`,
`dn compact`) are not ported yet.
"""

import json
import os
import re
from collections import OrderedDict
from datetime import datetime, timedelta, timezone

from . import query as mod_query
from . import index_journal as mod_journal
from .index_build_mt import interval_span
from .index_query_stack import canonical_item_sort

MANIFEST_VERSION = 1

# (level dir name, coarse-stem prefix length, fine intervals served).
# Coarsest first: the planner substitutes month shards before day
# shards, so a year query over an hour tree reads ~12 month shards
# plus edge-day/hour shards.
LEVELS = (
    ('by_month', 7, ('hour', 'day')),
    ('by_day', 10, ('hour',)),
)

_STEM_RE = {
    'hour': re.compile(r'^\d{4}-\d{2}-\d{2}-\d{2}$'),
    'day': re.compile(r'^\d{4}-\d{2}-\d{2}$'),
}
_DAY_RE = re.compile(r'^\d{4}-\d{2}-\d{2}$')
_MONTH_RE = re.compile(r'^\d{4}-\d{2}$')
_GEN_RE = re.compile(r'^(.+\.sqlite)-g(\d+)$')

SUFFIX = '.sqlite'


# -- generation naming -----------------------------------------------------

def split_generation(path):
    """(base_name_or_path, generation_number | None): a follow append
    batch lands as `<base>.sqlite-gNNNNNN` next to its base shard."""
    d, name = os.path.split(path)
    m = _GEN_RE.match(name)
    if m is None:
        return (path, None)
    return (os.path.join(d, m.group(1)), int(m.group(2)))


def logical_groups(paths):
    """Group an ordered fine-shard walk into logical shards: each base
    followed by its generations (base is a strict name prefix, so they
    sort adjacent).  Orphan generations whose base is absent still
    group together — their rows must be served."""
    groups = []
    index = {}
    for p in paths:
        base, gen = split_generation(p)
        if gen is None:
            index[p] = len(groups)
            groups.append([p])
            continue
        gi = index.get(base)
        if gi is None:
            index[base] = len(groups)
            groups.append([p])
        else:
            groups[gi].append(p)
    return groups


def augment_generation_files(root, files):
    """(path, statbuf)-pair variant of augment_generations for the
    datasource's bounded walk; inserted generations are statted
    fresh (one vanishing mid-walk is simply skipped, exactly as a
    racing find would miss it)."""
    try:
        names = os.listdir(root)
    except OSError:
        return list(files)
    gens = {}
    for name in names:
        base, gen = split_generation(name)
        if gen is not None:
            gens.setdefault(os.path.join(root, base),
                            []).append((gen, name))
    if not gens:
        return list(files)
    present = set(p for p, _st in files)
    out = []
    for p, st in files:
        out.append((p, st))
        for _, name in sorted(gens.get(p, ())):
            gp = os.path.join(root, name)
            if gp in present:
                continue
            try:
                gst = os.stat(gp)
            except OSError:
                continue
            out.append((gp, gst))
    return out


# -- stems and windows -----------------------------------------------------

def _parse_stem(stem, interval):
    """UTC start seconds a fine shard stem declares ('2014-07-02' /
    '2014-07-02-13'), or None when the name is not the interval's
    layout."""
    pat = _STEM_RE.get(interval)
    if pat is None or not pat.match(stem):
        return None
    try:
        if interval == 'hour':
            dt = datetime(int(stem[:4]), int(stem[5:7]),
                          int(stem[8:10]), int(stem[11:13]),
                          tzinfo=timezone.utc)
        else:
            dt = datetime(int(stem[:4]), int(stem[5:7]),
                          int(stem[8:10]), tzinfo=timezone.utc)
    except ValueError:
        return None
    return int(dt.timestamp())


def _coarse_window(levelname, stem):
    """[start_s, end_s) a rollup shard stem covers, or None for a
    malformed name."""
    try:
        if levelname == 'by_day':
            if not _DAY_RE.match(stem):
                return None
            start = datetime(int(stem[:4]), int(stem[5:7]),
                             int(stem[8:10]), tzinfo=timezone.utc)
            end = start + timedelta(days=1)
        else:
            if not _MONTH_RE.match(stem):
                return None
            start = datetime(int(stem[:4]), int(stem[5:7]), 1,
                             tzinfo=timezone.utc)
            end = start.replace(year=start.year + 1, month=1) \
                if start.month == 12 \
                else start.replace(month=start.month + 1)
    except ValueError:
        return None
    return (int(start.timestamp()), int(end.timestamp()))


def _shard_stem(name):
    """The time stem of a fine shard or generation filename, or
    None."""
    base, _gen = split_generation(os.path.basename(name))
    if not base.endswith(SUFFIX):
        return None
    return base[:-len(SUFFIX)]


def _source_statkey(path):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return [st.st_mtime_ns, st.st_size]


# -- the per-level source manifest ----------------------------------------

def manifest_path(leveldir):
    return os.path.join(leveldir, mod_journal.ROLLUP_MANIFEST)


def load_manifest(leveldir):
    """The level's source manifest, or None when absent/unreadable/
    wrong-shape (every consumer treats that as 'no valid rollups')."""
    try:
        with open(manifest_path(leveldir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or \
            doc.get('version') != MANIFEST_VERSION or \
            not isinstance(doc.get('shards'), dict):
        return None
    return doc


# -- the query planner -----------------------------------------------------

def plan_query(indexroot, interval, paths, query):
    """Map an ordered (pruned, generation-augmented) fine-shard walk
    onto the cheapest equivalent unit sequence:

      ['single', path]            one plain fine shard
      ['group', [paths...]]       a base + its mini-generations
      ['rollup', path, [bucket_s...]]  one rollup shard standing in
                                  for the listed fine buckets

    A rollup shard substitutes only when (a) its coarse window lies
    entirely inside the query bounds (or the query is unbounded) and
    (b) its manifest sources EXACTLY match the walk's files in that
    bucket — same names, same mtime_ns+size.  Anything else —
    compacted since the rollup was built, a fine shard added or
    removed, a partial month at the window edge — composes fine
    shards instead.  Returns None when the plan degenerates to plain
    single-file units: the caller keeps the existing stacked/pooled
    execution path untouched."""
    if interval not in _STEM_RE:
        return None
    groups = logical_groups(paths)
    fine_span = interval_span(interval)
    ginfo = []
    for g in groups:
        stem = _shard_stem(g[0])
        bucket_s = _parse_stem(stem, interval) if stem else None
        ginfo.append((stem, bucket_s))
    covered = [None] * len(groups)
    nrollup = 0
    rollup_root = os.path.join(os.path.abspath(indexroot),
                               mod_journal.ROLLUP_DIR)
    if os.path.isdir(rollup_root):
        for levelname, klen, fine_ok in LEVELS:
            if interval not in fine_ok:
                continue
            leveldir = os.path.join(rollup_root, levelname)
            man = load_manifest(leveldir)
            if man is None or man.get('fine_span') != fine_span:
                continue
            shards = man['shards']
            buckets = OrderedDict()
            for i, (stem, bucket_s) in enumerate(ginfo):
                if covered[i] is None and bucket_s is not None:
                    buckets.setdefault(stem[:klen], []).append(i)
            for cstem, idxs in buckets.items():
                ent = shards.get(cstem + SUFFIX)
                if not isinstance(ent, dict):
                    continue
                window = _coarse_window(levelname, cstem)
                if window is None:
                    continue
                if query.qc_after is not None and not (
                        query.qc_after <= window[0] * 1000 and
                        window[1] * 1000 <= query.qc_before):
                    continue
                rpath = os.path.join(leveldir, cstem + SUFFIX)
                if _source_statkey(rpath) is None:
                    continue
                if not _sources_match(ent.get('sources'),
                                      [groups[i] for i in idxs]):
                    continue
                for i in idxs:
                    covered[i] = rpath
                nrollup += 1
    units = []
    for i, g in enumerate(groups):
        rpath = covered[i]
        if rpath is None:
            if len(g) > 1:
                units.append(['group', g])
            else:
                units.append(['single', g[0]])
        elif units and units[-1][0] == 'rollup' and \
                units[-1][1] == rpath:
            units[-1][2].append(ginfo[i][1])
        else:
            units.append(['rollup', rpath, [ginfo[i][1]]])
    if nrollup == 0 and all(u[0] == 'single' for u in units):
        return None
    return {'units': units, 'fine_span': fine_span,
            'nlogical': len(groups),
            'ncovered': sum(1 for c in covered if c is not None),
            'nrollup': nrollup}


def _sources_match(sources, bucket_groups):
    """The planner's validity test: the manifest's recorded source set
    equals the walk's files for this bucket, byte-for-byte (statkey
    equality re-statted now, not at walk time — a stale substitute is
    worse than a slow fallback)."""
    if not isinstance(sources, dict):
        return False
    have = {}
    for g in bucket_groups:
        for p in g:
            have[os.path.basename(p)] = p
    if set(have) != set(sources):
        return False
    for name, path in have.items():
        sk = sources[name]
        if not isinstance(sk, list) or _source_statkey(path) != sk:
            return False
    return True


def rollup_query(query, fine_span):
    """The planner's rewritten query for a rollup shard: the user's
    query with a reserved `__dn_ts` lquantize breakdown (step = the
    FINE span, no date annotation) prepended.  The shard's GROUP BY
    then emits ts-major slices that are, per fine bucket, exactly the
    fine shard's own emission for the original query."""
    bd = [{'name': '__dn_ts', 'field': '__dn_ts',
           'aggr': 'lquantize', 'step': fine_span}]
    bd.extend(query.qc_breakdowns)
    return mod_query.QueryConfig(
        filter=query.qc_filter, breakdowns=bd,
        time_after=query.qc_after, time_before=query.qc_before)


def execute_plan(plan, query, query_one, on_items):
    """Run a plan: `query_one(path, queryconfig)` must return the
    shard's key_items (the caller chooses cached vs uncached reads);
    `on_items(items)` is called once per LOGICAL fine shard, in walk
    order — the same call pattern, counter arithmetic, and item
    stream as the plain fine walk."""
    bare = not query.qc_breakdowns
    q2 = None
    ts_bz = None
    for unit in plan['units']:
        kind = unit[0]
        if kind == 'single':
            on_items(query_one(unit[1], query))
        elif kind == 'group':
            acc = OrderedDict()
            for path in unit[1]:
                for k, v in query_one(path, query):
                    if k in acc:
                        acc[k] = acc[k] + v
                    else:
                        acc[k] = v
            on_items(canonical_item_sort(list(acc.items())))
        else:
            if q2 is None:
                q2 = rollup_query(query, plan['fine_span'])
                ts_bz = q2.qc_bucketizers['__dn_ts']
            slices = {}
            for k, v in query_one(unit[1], q2):
                slices.setdefault(k[0], []).append((k[1:], v))
            for bucket_s in unit[2]:
                items = slices.get(ts_bz.bucketize(bucket_s))
                if items is None:
                    # SQL SUM over an empty shard emits one NULL->0
                    # row; grouped queries emit nothing
                    items = [((), 0)] if bare else []
                on_items(items)
