"""Multi-resolution rollup shards, follow mini-generations, and the
query planner that serves from the coarsest covering shard set.

Counterpart of dragnet_tpu/rollup.py (whole): the builder (`dn
rollup`), the compactor (`dn compact`) and the planner `dn query`
reads through.

Three cooperating pieces, all downstream of one invariant — the item
stream a query observes is byte-identical to the plain fine-shard
walk:

* **Rollup shards** (`build_rollups`, `dn rollup`): day-from-hour and
  month-from-day(-or-hour) shards under `<indexroot>/rollup/<level>/`,
  built by MERGING existing fine index shards — no raw rescan.  A
  rollup shard is the exact concatenation of its fine sources' rows
  with a synthetic `__dn_ts` INTEGER column (lquantize at the FINE
  span) prepended, published through the same two-phase journal +
  integrity catalog as any build.  Each level carries a
  `.dn_rollup.json` manifest recording exactly which fine files
  (name + mtime_ns + size) each rollup shard was built from; a rollup
  whose recorded sources disagree with the live tree is silently
  inert — the planner falls back to the fine shards.

* **Mini-generations** (`dn follow --append`): instead of
  read-modify-rewriting a whole shard per batch, the follow publisher
  lands each batch as `<shard>-gNNNNNN` next to its base.  The base
  name is a strict prefix, so sorted walks replay base then
  generations in publish order; queries treat the group as ONE
  logical shard (sum-merge by key, then the engines' GROUP BY
  collation order — `index_query_stack.canonical_item_sort` — which
  is exactly what querying the compacted shard emits).

* **Compaction** (`compact_tree`): rewrite base + generations into
  one shard via the follow publisher's Aggregator replay (stored rows
  re-keyed through the metric's build query — the same
  structurally-byte-exact argument follow/publisher.py documents).
  The consumed generations ride the publish commit record as
  `deletes` and are unlinked only after the rename lands, so a crash
  at any instant leaves either the full generation set or the
  compacted shard, never a tree missing rows.

Why the rollup read is byte-identical: the planner rewrites the user
query for a rollup shard by prepending a `__dn_ts` lquantize
breakdown at the fine span (`rollup_query`).  The shard's GROUP BY
emits rows ts-major in the engines' pinned ascending collation, so
slicing on the leading ordinal yields, per fine bucket, exactly the
row set (same grouping, same within-group sums — rollup rows are
verbatim copies of fine rows, so values are bit-exact) in exactly the
order the fine shard's own GROUP BY emits.  Stripping the leading
ordinal and replaying the slices in chronological (find) order
reproduces the fine walk's item stream, including per-shard
first-occurrence key order.  Bare-SUM queries (no breakdowns) get one
`((), 0)` synthesized per covered fine shard with no surviving rows,
mirroring SQL's `SUM() -> NULL -> 0` per-shard emission.  The one
caveat mirrors the follow publisher's: non-integral weights merged
across a generation group can differ from the compacted shard in the
last ulp (float addition order); integral weights are exact.
"""

import json
import os
import re
from collections import OrderedDict
from datetime import datetime, timedelta, timezone

from .errors import DNError
from . import query as mod_query
from . import faults as mod_faults
from . import index_journal as mod_journal
from .aggr import Aggregator
from .vpipe import counter_bump
from .index_build_mt import (_breakdown_positions, _notify_index_written,
                             _prepare_task, interval_span,
                             publish_prepared)
from .index_query import open_index
from .index_query_stack import canonical_item_sort
from .index_sink import metric_catalog_rows

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


def generation_paths(base_path):
    """Existing generation files of a base shard, in generation
    order."""
    d, base = os.path.split(base_path)
    prefix = base + mod_journal.GEN_SEP
    try:
        names = os.listdir(d or '.')
    except OSError:
        return []
    found = []
    for name in names:
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            found.append((int(name[len(prefix):]),
                          os.path.join(d, name)))
    return [p for _, p in sorted(found)]


def next_generation_path(base_path):
    """Where the follow appender's next mini-generation for this base
    shard lands.  Zero-padded to six digits so lexicographic directory
    order is publish order."""
    gens = generation_paths(base_path)
    n = split_generation(gens[-1])[1] if gens else 0
    return '%s%s%06d' % (base_path, mod_journal.GEN_SEP, n + 1)


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


def augment_generations(root, paths):
    """Insert existing generation files after their bases in an
    ordered shard list.  Bounded index walks enumerate exact in-window
    filenames (find.create_path_enumerator) and so can never name a
    generation; one listdir of the interval directory recovers them."""
    try:
        names = os.listdir(root)
    except OSError:
        return list(paths)
    gens = {}
    for name in names:
        base, gen = split_generation(name)
        if gen is not None:
            gens.setdefault(os.path.join(root, base),
                            []).append((gen, name))
    if not gens:
        return list(paths)
    present = set(paths)
    out = []
    for p in paths:
        out.append(p)
        for _, name in sorted(gens.get(p, ())):
            gp = os.path.join(root, name)
            if gp not in present:
                out.append(gp)
    return out


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


def write_manifest(leveldir, fine_span, shards):
    """Durable-metadata write: fsynced tmp + atomic rename.  The tmp
    carries the owner pid at the sweep's expected position
    (`.dn_rollup.json.<pid>.tmp`) so a crashed writer's tmp is
    quarantined, and a torn manifest can never exist."""
    final = manifest_path(leveldir)
    tmp = '%s.%d.tmp' % (final, os.getpid())
    doc = {'version': MANIFEST_VERSION, 'fine_span': fine_span,
           'shards': shards}
    with open(tmp, 'w') as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)


# -- metric reconstruction -------------------------------------------------

def metrics_from_catalog(qr):
    """Reconstruct the Metric set a shard was built under from its
    embedded catalog, so `dn rollup` and the compactor work from the
    tree alone (no build/follow config).  Round-trips byte-exactly:
    metric_serialize of the reconstruction re-emits the stored catalog
    strings (serialize writes keys in a fixed order and JSON parsing
    preserves object order)."""
    out = []
    for met in qr.qi_metrics:
        out.append(mod_query.metric_deserialize({
            'name': met['qm_label'],
            'datasource': None,
            'filter': met['qm_filter'],
            'breakdowns': [dict(p) for p in met['qm_params']],
        }))
    return out


def _rollup_contexts(fine_metrics, fine_span):
    """(rollup metrics, per-metric replay contexts) for building a
    rollup shard.  The rollup metric is the fine metric with a
    reserved `__dn_ts` lquantize breakdown (step = FINE span, no
    date annotation) prepended: the stored column keeps each row's
    fine bucket start, and omitting the date annotation keeps
    find_metric's datefield resolution — and therefore bounded-query
    behavior, including its failure mode — identical to the fine
    shards'."""
    ts_bd = {'b_name': '__dn_ts', 'b_field': '__dn_ts',
             'b_aggr': 'lquantize', 'b_step': fine_span}
    roll_metrics = []
    ctxs = []
    for m in fine_metrics:
        rm = mod_query.Metric(
            m.m_name, None, m.m_filter,
            [dict(ts_bd)] + [dict(b) for b in m.m_breakdowns])
        q = mod_query.metric_query(rm, None, None, 'all', '__dn_ts')
        if isinstance(q, DNError):
            raise q
        roll_metrics.append(rm)
        ctxs.append({
            'q': q,
            'names': [b['b_name'] for b in m.m_breakdowns],
            'bz': q.qc_bucketizers,
            'ts_bz': q.qc_bucketizers['__dn_ts'],
        })
    return roll_metrics, ctxs


# -- rollup building -------------------------------------------------------

def _build_bucket(indexroot, finedir, leveldir, interval, fine_span,
                  snames, rpath, start_s, nworkers):
    """Build one rollup shard from its fine sources.  Returns the
    {name: statkey} map describing exactly the bytes read, or None
    when a concurrent publish moved a source mid-build (the next pass
    rebuilds; publishing a manifest entry that mis-describes its
    sources would let the planner serve a stale rollup)."""
    from .follow.publisher import _check_catalog, _row_key
    paths = [os.path.join(finedir, n) for n in snames]
    sources = {}
    for sname, path in zip(snames, paths):
        sk = _source_statkey(path)
        if sk is None:
            return None
        sources[sname] = sk
    fine_metrics = None
    roll_metrics = ctxs = aggrs = None
    for sname, path in zip(snames, paths):
        bucket_s = _parse_stem(_shard_stem(sname), interval)
        qr = open_index(path)
        try:
            if fine_metrics is None:
                fine_metrics = metrics_from_catalog(qr)
                roll_metrics, ctxs = _rollup_contexts(fine_metrics,
                                                      fine_span)
                aggrs = [Aggregator(ctx['q']) for ctx in ctxs]
            else:
                _check_catalog(qr, fine_metrics, path)
            for mi, ctx in enumerate(ctxs):
                ts_ord = ctx['ts_bz'].bucketize(bucket_s)
                for row in qr.metric_rows(mi, ctx['names']):
                    aggrs[mi].write_key(
                        _row_key(ctx, ts_ord, row[:-1]), row[-1])
        finally:
            qr.close()
    for sname, path in zip(snames, paths):
        if _source_statkey(path) != sources[sname]:
            counter_bump('rollup builds raced')
            return None
    parts = []
    for mi, aggr in enumerate(aggrs):
        cols, weights = aggr.point_rows()
        if not weights:
            continue       # mirror the fine build: no block, no table
        sel = _breakdown_positions(list(aggr.decomps),
                                   roll_metrics[mi])
        parts.append((mi, [cols[p] for p in sel], weights))
    os.makedirs(leveldir, exist_ok=True)
    catalog = metric_catalog_rows(roll_metrics)
    journal = mod_journal.BuildJournal(indexroot)
    sinks = [None]
    task = _prepare_task(roll_metrics, rpath, {'dn_start': start_s},
                         parts, catalog, journal.tmp_suffix, sinks, 0)
    try:
        task()
        mod_faults.fire('rollup.publish')
    except BaseException:
        for sink in sinks:
            if sink is not None:
                sink.abort()
        raise
    publish_prepared(journal, sinks, [rpath])
    return sources


def build_rollups(indexroot, interval, nworkers=None, governor=None):
    """Build/refresh every level's rollup shards for one interval
    tree, publishing each through the two-phase journal and recording
    provenance in the level manifest.  Incremental: buckets whose
    manifest entry still matches the live fine files are skipped.
    Rollup shards whose coarse bucket no longer exists are removed.
    A resource governor in any pressure mode pauses the pass (rollups
    are an optimization; never compete with serving for a full
    disk)."""
    doc = {'levels': {}, 'built': 0, 'fresh': 0, 'removed': 0,
           'paused': False}
    if interval not in _STEM_RE:
        return doc
    indexroot = os.path.abspath(indexroot)
    finedir = os.path.join(indexroot, 'by_' + interval)
    fine_span = interval_span(interval)
    try:
        names = sorted(os.listdir(finedir))
    except OSError:
        return doc
    shard_names = [
        n for n in names
        if not mod_journal.is_index_litter(n) and
        _shard_stem(n) is not None and
        _parse_stem(_shard_stem(n), interval) is not None and
        os.path.isfile(os.path.join(finedir, n))]
    published = []
    for levelname, klen, fine_ok in LEVELS:
        if interval not in fine_ok:
            continue
        leveldir = os.path.join(indexroot, mod_journal.ROLLUP_DIR,
                                levelname)
        ldoc = {'built': 0, 'fresh': 0, 'removed': 0}
        doc['levels'][levelname] = ldoc
        buckets = OrderedDict()
        for n in shard_names:
            buckets.setdefault(_shard_stem(n)[:klen], []).append(n)
        old_man = load_manifest(leveldir)
        old_shards = {}
        if old_man is not None and \
                old_man.get('fine_span') == fine_span:
            old_shards = old_man['shards']
        new_shards = {}
        attempted = set()
        for cstem, snames in buckets.items():
            if governor is not None and governor.mode() != 'ok':
                doc['paused'] = True
                counter_bump('rollup builds paused')
                break
            window = _coarse_window(levelname, cstem)
            if window is None:
                continue
            rname = cstem + SUFFIX
            attempted.add(rname)
            rpath = os.path.join(leveldir, rname)
            current = {}
            for sname in snames:
                sk = _source_statkey(os.path.join(finedir, sname))
                if sk is not None:
                    current[sname] = sk
            old = old_shards.get(rname)
            if isinstance(old, dict) and \
                    old.get('sources') == current and \
                    _source_statkey(rpath) is not None:
                new_shards[rname] = {'sources': current}
                ldoc['fresh'] += 1
                continue
            sources = _build_bucket(indexroot, finedir, leveldir,
                                    interval, fine_span, snames,
                                    rpath, window[0], nworkers)
            if sources is None:
                continue
            new_shards[rname] = {'sources': sources}
            published.append(rpath)
            ldoc['built'] += 1
            counter_bump('rollup shards built')
        if not doc['paused']:
            # retire rollup shards whose coarse bucket vanished
            from . import integrity as mod_integrity
            from .index_query_mt import shard_cache_invalidate
            try:
                have = sorted(os.listdir(leveldir))
            except OSError:
                have = []
            for name in have:
                if not name.endswith(SUFFIX) or name in attempted \
                        or mod_journal.is_index_litter(name):
                    continue
                path = os.path.join(leveldir, name)
                try:
                    os.unlink(path)
                except OSError:
                    continue
                shard_cache_invalidate(path)
                mod_integrity.update_catalog(
                    indexroot,
                    remove=[mod_integrity.shard_rel(indexroot, path)])
                ldoc['removed'] += 1
        if new_shards or os.path.exists(manifest_path(leveldir)):
            os.makedirs(leveldir, exist_ok=True)
            write_manifest(leveldir, fine_span, new_shards)
        doc['built'] += ldoc['built']
        doc['fresh'] += ldoc['fresh']
        doc['removed'] += ldoc['removed']
        if doc['paused']:
            break
    if published or doc['removed']:
        _notify_index_written(indexroot, published)
    return doc


# -- compaction ------------------------------------------------------------

def find_gen_groups(indexroot, interval):
    """[(base_path, [generation paths])] for every base shard with at
    least one pending mini-generation, in shard order.  An orphan
    generation set (base missing — not reachable through the publish
    protocol, but trees are operator-editable) is reported with its
    would-be base path."""
    root = os.path.join(indexroot, 'by_' + interval)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    gens = {}
    for name in names:
        if mod_journal.is_index_litter(name):
            continue
        base, gen = split_generation(name)
        if gen is not None:
            gens.setdefault(base, []).append((gen, name))
    out = []
    for base in sorted(gens):
        out.append((os.path.join(root, base),
                    [os.path.join(root, n)
                     for _, n in sorted(gens[base])]))
    return out


def compaction_backlog(indexroot, interval):
    """Pending mini-generation files in one interval tree (the `dn
    top` / /stats backlog gauge)."""
    return sum(len(g) for _, g in find_gen_groups(indexroot,
                                                  interval))


def compact_group(indexroot, interval, base_path, gen_paths,
                  nworkers=None):
    """Rewrite one base shard + its mini-generations into a single
    shard, deleting the consumed generations through the commit
    record (see module docstring for the crash argument).  The
    rewrite replays every member's stored rows through the metric's
    build query — the follow publisher's structurally-byte-exact
    merge — so the result equals a from-scratch build over the same
    records."""
    from .follow.publisher import (_check_catalog, _row_key,
                                   metric_contexts)
    from . import integrity as mod_integrity
    stem = _shard_stem(base_path)
    bucket_s = _parse_stem(stem, interval) if stem else None
    if bucket_s is None:
        raise DNError('cannot compact "%s": filename does not match '
                      'the %s interval layout' % (base_path, interval))
    members = ([base_path] if os.path.exists(base_path) else []) \
        + list(gen_paths)
    metrics = None
    ctxs = None
    rows_by_member = []
    for path in members:
        qr = open_index(path)
        try:
            if metrics is None:
                metrics = metrics_from_catalog(qr)
                _span, ctxs = metric_contexts(metrics, interval,
                                              '__dn_ts')
            else:
                _check_catalog(qr, metrics, path)
            rows_by_member.append(
                [qr.metric_rows(mi, ctxs[mi]['names'])
                 for mi in range(len(metrics))])
        finally:
            qr.close()
    parts = []
    for mi, ctx in enumerate(ctxs):
        aggr = Aggregator(ctx['q'])
        ts_ord = ctx['ts_bz'].bucketize(bucket_s) \
            if ctx['ts_bz'] is not None else None
        for rows in rows_by_member:
            for row in rows[mi]:
                aggr.write_key(_row_key(ctx, ts_ord, row[:-1]),
                               row[-1])
        cols, weights = aggr.point_rows()
        if not weights:
            continue
        sel = _breakdown_positions(list(aggr.decomps), metrics[mi])
        parts.append((mi, [cols[p] for p in sel], weights))
    catalog = metric_catalog_rows(metrics)
    journal = mod_journal.BuildJournal(indexroot)
    sinks = [None]
    task = _prepare_task(metrics, base_path, {'dn_start': bucket_s},
                         parts, catalog, journal.tmp_suffix, sinks, 0)
    try:
        task()
        mod_faults.fire('compact.publish')
    except BaseException:
        for sink in sinks:
            if sink is not None:
                sink.abort()
        raise
    rels = [mod_integrity.shard_rel(indexroot, p) for p in gen_paths]
    publish_prepared(
        journal, sinks, [base_path], deletes=list(gen_paths),
        integrity_remove={os.path.abspath(indexroot): rels})
    _notify_index_written(indexroot,
                          [base_path] + list(gen_paths))


def compact_tree(indexroot, interval, governor=None, min_gens=1,
                 max_groups=None, nworkers=None):
    """One compaction pass over an interval tree: every base shard
    with >= min_gens pending mini-generations is rewritten.  Pauses
    (and reports paused=True) as soon as the disk governor leaves
    'ok' — compaction is a space-amplifying rewrite and must yield to
    the low watermark.  `max_groups` bounds one pass so a serve-
    resident timer shares the tree politely."""
    doc = {'groups': 0, 'compacted': 0, 'generations_removed': 0,
           'paused': False}
    if interval not in _STEM_RE:
        return doc
    indexroot = os.path.abspath(indexroot)
    groups = [(b, g) for b, g in find_gen_groups(indexroot, interval)
              if len(g) >= max(1, min_gens)]
    doc['groups'] = len(groups)
    if not groups:
        return doc
    mod_journal.sweep_index_tree(indexroot)
    for base, gens in groups:
        if governor is not None and governor.mode() != 'ok':
            doc['paused'] = True
            counter_bump('compactions paused')
            break
        if max_groups is not None and doc['compacted'] >= max_groups:
            break
        compact_group(indexroot, interval, base, gens,
                      nworkers=nworkers)
        doc['compacted'] += 1
        doc['generations_removed'] += len(gens)
        counter_bump('index shards compacted')
        counter_bump('index generations removed', len(gens))
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
