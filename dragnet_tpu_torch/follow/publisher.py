"""Mini-batch publish: scan the batch through the existing columnar
build path, merge its points into the affected shards, publish the
touched set (plus the checkpoint) through the two-phase journal.

Counterpart (a copy) of dragnet_tpu/follow/publisher.py.

Byte-equality with a from-scratch `dn build` over the same prefix is
structural, not tested-into-existence:

* The batch scans through the SAME path a build uses (a spool
  DatasourceFile + index_scan — byteparse lanes, datasource filter,
  metric filters, vectorized aggregation all included), so its tagged
  points are exactly the build's aggregates over the new records.
* Each touched shard is rewritten read-modify-publish: the existing
  rows (metric_rows, in stored == emission order) seed a fresh
  Aggregator for the metric's build query, then the batch's points
  merge in.  Aggregator key replay is order-preserving for string
  keys and re-sorts numeric keys at emission (aggr.key_items's
  documented equivalence), and because hour/day build queries prepend
  `__dn_ts` (step == the shard span) as the FIRST breakdown, every
  deeper level's insertion order is scoped to this shard's own
  records — no cross-shard order coupling.  The rewrite therefore
  emits exactly the rows, in exactly the order, a from-scratch build
  over old+new records would have written.
* Weight sums are exact for integral weights (the `json` format's
  weight-1 records, and any integer-valued stream).  Non-integral
  json-skinner weights can differ in the last ulp from a from-scratch
  build (float addition order), the same caveat index_query_stack's
  exactness gate documents.

The whole touched set — every rewritten shard AND the post-batch
checkpoint — publishes through one BuildJournal commit record
(publish_prepared extra_paths), so kill -9 at any instant leaves the
recovery sweep a pre-batch or post-batch tree, never a mix and never
a checkpoint that disagrees with the data.
"""

import os
from collections import OrderedDict

from ..errors import DNError
from .. import query as mod_query
from ..aggr import Aggregator, coerce_bucket_value
from ..vpipe import counter_bump
from .. import faults as mod_faults
from .. import index_journal as mod_journal
from ..index_build_mt import (_breakdown_positions, _notify_index_written,
                              _prepare_task, bucket_label, interval_span,
                              publish_prepared, run_flush_tasks)
from ..index_query import open_index
from ..index_sink import metric_catalog_rows, point_metric


def metric_contexts(metrics, interval, timefield):
    """(span, per-metric ctx) for the merge: the metric's build query
    (metric_query — identical to what build/index_scan aggregate
    under), its breakdown names, and its bucketizers."""
    span = None if interval == 'all' else interval_span(interval)
    ctxs = []
    for m in metrics:
        q = mod_query.metric_query(m, None, None, interval, timefield)
        ctxs.append({
            'q': q,
            'names': [b['b_name'] for b in m.m_breakdowns],
            'bz': q.qc_bucketizers,
            'ts_bz': q.qc_bucketizers.get('__dn_ts'),
        })
    return span, ctxs


def _bucket_key(ctx, fields, missing_ok=False):
    """A tagged point's key tuple in the metric's aggregator key space
    (ordinals for bucketized fields, stored strings otherwise) — the
    exact inverse of points() decoding (bucketize(bucket_min(i)) == i
    for both bucketizers)."""
    keys = []
    if ctx['ts_bz'] is not None:
        v = coerce_bucket_value(fields.get('__dn_ts'))
        if v is None:
            raise DNError('index point has non-numeric "__dn_ts": %r'
                          % (fields.get('__dn_ts'),))
        keys.append(ctx['ts_bz'].bucketize(v))
    for name in ctx['names']:
        if name not in fields:
            raise DNError('point is missing breakdown "%s"' % name)
        v = fields[name]
        bz = ctx['bz'].get(name)
        if bz is not None:
            cv = coerce_bucket_value(v)
            if cv is None:
                raise DNError('value for field "%s" is not a number'
                              % name)
            keys.append(bz.bucketize(cv))
        else:
            keys.append(v)
    return tuple(keys)


def _row_key(ctx, ts_ord, row_keys):
    """A stored shard row's key tuple in the same key space (seeding):
    `ts_ord` is the shard's own __dn_ts ordinal (every row of an
    hour/day shard shares it — the shard IS the bucket)."""
    keys = []
    if ts_ord is not None:
        keys.append(ts_ord)
    for name, v in zip(ctx['names'], row_keys):
        bz = ctx['bz'].get(name)
        if bz is not None:
            cv = coerce_bucket_value(v)
            if cv is None:
                raise DNError('index row has non-numeric value for '
                              'bucketized field "%s": %r' % (name, v))
            keys.append(bz.bucketize(cv))
        else:
            keys.append(v)
    return tuple(keys)


def _check_catalog(qr, metrics, path):
    """A shard about to be merged into must describe the SAME metric
    set the follow is building — a silent mismatch would scramble
    tables; fail clean instead."""
    mets = qr.qi_metrics
    ok = len(mets) == len(metrics)
    if ok:
        for met, m in zip(mets, metrics):
            if met['qm_label'] != m.m_name or \
                    [p.get('name') for p in met['qm_params']] != \
                    [b['b_name'] for b in m.m_breakdowns]:
                ok = False
                break
    if not ok:
        raise DNError('index "%s": shard metric catalog does not '
                      'match the follow configuration' % path)


def group_points(tagged, metrics, ctxs, span):
    """Route a batch's tagged points: bucket_start -> {metric index ->
    [(key_tuple, value)]}, preserving points() emission order (the
    order the merge replays them in)."""
    groups = OrderedDict()
    if span is None:
        groups[None] = OrderedDict()
    for fields, value in tagged:
        mi = point_metric(fields, len(metrics))
        if span is None:
            bucket_s = None
        else:
            dnts = coerce_bucket_value(fields.get('__dn_ts'))
            if dnts is None:
                raise DNError('index point has non-numeric '
                              '"__dn_ts": %r'
                              % (fields.get('__dn_ts'),))
            bucket_s = int(dnts // span) * span
        key = _bucket_key(ctxs[mi], fields)
        groups.setdefault(bucket_s, OrderedDict()) \
              .setdefault(mi, []).append((key, value))
    return groups


def _merged_parts(path, metrics, ctxs, span, bucket_s, new_by_mi):
    """One touched shard's merged write blocks [(mi, keycols,
    weights)]: existing rows seed, batch points merge, point_rows
    emits — see the module docstring for why this is byte-exact."""
    old = None
    if os.path.exists(path):
        qr = open_index(path)
        try:
            _check_catalog(qr, metrics, path)
            old = [qr.metric_rows(mi, ctxs[mi]['names'])
                   for mi in range(len(metrics))]
        finally:
            qr.close()
    parts = []
    for mi, ctx in enumerate(ctxs):
        items = new_by_mi.get(mi, [])
        aggr = Aggregator(ctx['q'])
        if old is not None and old[mi]:
            ts_ord = ctx['ts_bz'].bucketize(bucket_s) \
                if ctx['ts_bz'] is not None else None
            for row in old[mi]:
                aggr.write_key(_row_key(ctx, ts_ord, row[:-1]),
                               row[-1])
        if items:
            aggr.merge_key_items(items)
        cols, weights = aggr.point_rows()
        if not weights and span is not None:
            # a from-scratch hour/day build writes no block for a
            # metric with no rows in this bucket; mirror it
            continue
        sel = _breakdown_positions(list(aggr.decomps), metrics[mi])
        parts.append((mi, [cols[p] for p in sel], weights))
    return parts


def merge_publish(metrics, interval, indexroot, timefield, tagged,
                  checkpointer, seq, sources, nworkers=None,
                  recover=True, append=False):
    """Merge one batch's tagged points into the index tree and publish
    the touched shards + the post-batch checkpoint atomically.
    Returns the list of published shard paths.

    `recover=False` skips the tree sweep + own-journal recovery —
    three full directory listings per call otherwise.  Only safe when
    the caller KNOWS the tree is clean: FollowLoop sweeps once in
    resume() and passes recover=True only on the retry after a failed
    publish (the sole in-process way intent can be left behind on a
    single-follower tree).

    `append=True` (dn follow --append): a bucket whose base shard
    already exists lands the batch as a mini-generation
    (`<shard>.sqlite-gNNNNNN`, rollup.next_generation_path) instead of
    read-modify-rewriting the whole shard — O(batch) bytes per
    publish, no seed read.  Queries fold base+generations into one
    logical shard and the compactor (rollup.compact_tree) rewrites
    the group back to a single file.  A generation-number race with a
    concurrent compactor is benign: the compactor only consumes the
    generations it listed, a generation published after its listing
    survives next to the compacted base, and numbering gaps are fine
    (generation order is numeric over whatever exists).  Only hour/
    day trees append; the 'all' shard always merges in place."""
    span, ctxs = metric_contexts(metrics, interval, timefield)
    groups = group_points(tagged, metrics, ctxs, span)
    catalog = metric_catalog_rows(metrics)

    if recover:
        mod_journal.sweep_index_tree(indexroot)
        # a previous attempt that failed AFTER its commit record left
        # complete intent: finish its renames (quarantining them would
        # let this retry re-merge over a half-renamed tree and double-
        # count), then detect the completed batch via the checkpoint
        # seq and skip it — the retry-is-exact contract
        completed = mod_journal.recover_own_committed(indexroot)
        mod_journal.cleanup_own_stale(indexroot)
        if completed:
            _notify_index_written(indexroot, completed)
    # the seq backstop stays unconditional — one tiny-JSON read —
    # so a replayed batch can never double-apply
    doc = checkpointer.load()
    if doc is not None and int(doc.get('seq') or 0) >= seq:
        counter_bump('follow batch replays skipped')
        return []
    journal = mod_journal.BuildJournal(indexroot)

    if span is None:
        ordered_buckets = [None]
        root = indexroot
    else:
        ordered_buckets = sorted(groups)
        root = os.path.join(indexroot, 'by_' + interval)

    ngens = 0
    buckets = []
    for bucket_s in ordered_buckets:
        if bucket_s is None:
            path = os.path.join(root, 'all')
            config = None
        else:
            path = os.path.join(
                root, bucket_label(bucket_s, interval) + '.sqlite')
            config = {'dn_start': bucket_s}
        if append and bucket_s is not None and os.path.exists(path):
            from .. import rollup as mod_rollup
            # the generation path never exists, so _merged_parts
            # seeds nothing: the shard holds exactly this batch's
            # points for the bucket
            path = mod_rollup.next_generation_path(path)
            ngens += 1
        parts = _merged_parts(path, metrics, ctxs, span, bucket_s,
                              groups.get(bucket_s) or {})
        buckets.append((path, config, parts))
    if ngens:
        counter_bump('follow generations appended', ngens)

    paths = [p for p, config, parts in buckets]
    sinks = [None] * len(buckets)
    tasks = [_prepare_task(metrics, path, config, parts, catalog,
                           journal.tmp_suffix, sinks, i)
             for i, (path, config, parts) in enumerate(buckets)]
    try:
        run_flush_tasks(tasks, nworkers)
    except BaseException:
        for sink in sinks:
            if sink is not None:
                sink.abort()
        raise
    try:
        # the drill seam: an error here aborts the whole batch clean
        # (nothing landed, retry later); a kill here is the classic
        # crash between prepare and commit — the sweep rolls BACK and
        # the resumed follower re-ingests from the old checkpoint
        mod_faults.fire('follow.publish')
        ckpt_final = checkpointer.prepare(journal, seq, sources)
    except BaseException:
        for sink in sinks:
            if sink is not None:
                sink.abort()
        raise
    publish_prepared(journal, [s for s in sinks], paths,
                     extra_paths=[ckpt_final])
    _notify_index_written(indexroot, paths)
    return paths
