"""The device lane of the stacked index query: slot-packed shard
tensors folded by scatter-add into one i64 accumulator on the card.

Counterpart of dragnet_tpu/device_index.py.  Once the stacked batch
exists (index_query_stack.run_stacked), the per-tuple weight sums are
one scatter-add of every shard's rows into dense bucket tensors:

* **Shard-batch staging.**  Rows arrive perm-ordered by (shard, sort
  keys...), so each shard occupies one contiguous slice.  Per shard
  the host stages the LOCAL group code per row (first-occurrence rank
  of the row's aggregate tuple within the shard) and the integer
  weight, plus a translation row mapping local codes to the query's
  global segment ids.
* **Slot-packed dispatches.**  Shards group by pow2-padded row count
  and pack S at a time (a pow2 ladder bounded by
  DN_INDEX_DEVICE_BATCH_ROWS and _MAX_SLOTS) into one fold
  (`_fold_program`): a gather of each slot's local codes through its
  translation row, then one i64 `index_add_` into the accumulator.  The
  ladder, and with it the dispatch count, is the reference's.
* **Device-resident fold, ONE fetch.**  The accumulator stays on the
  card through every dispatch (added in place; the reference re-feeds
  its jit output), and only `acc[:nuniq]` comes back, once, as float64
  — the host bincount's type, part of byte identity.

Lane routing (`lane_decision`): DN_INDEX_DEVICE=0 pins the host
`np.bincount`; otherwise the port's device engine (its default) forces
the device and its host engine stays on the host.  The reference's
audition-gated `auto` comes with the port's auto routing; its
residency pins come with `dn serve`.

Exactness: integer atomics are exact and independent of order, so the
i64 sums of the integer weights the stacked gate admits are bit-equal
to the host path.  There is no silent host fallback: on the device lane
a failed fold raises.  The host bincount runs only on the structural
routes (a segment count past the dense ceiling, no rows), and every
route a query takes is recorded in the engagement snapshot
(`stats_doc()['routes']`).
"""

import os

import numpy as np

# per-process engagement snapshot: dispatches/shards/rows/upload bytes
# since process start, the last lane, and a count per aggregation route
_ENGAGE = {
    'dispatches': 0,
    'shards': 0,
    'rows': 0,
    'h2d_bytes': 0,
    'last_lane': None,
    'last_route': None,
    'routes': {},
}
_MAX_SLOTS = 64


def _reset_engagement():
    """Test/bench hook: zero the per-process engagement snapshot."""
    for k in ('dispatches', 'shards', 'rows', 'h2d_bytes'):
        _ENGAGE[k] = 0
    _ENGAGE['last_lane'] = _ENGAGE['last_route'] = None
    _ENGAGE['routes'] = {}


def note_route(route):
    """Record the aggregation route a query took: 'device', a 'host: '
    route of the stacked path, a 'per-shard: ' fall-back or 'rollup
    plan' (datasource_file.DatasourceFile.query)."""
    _ENGAGE['last_route'] = route
    _ENGAGE['routes'][route] = _ENGAGE['routes'].get(route, 0) + 1


def _pow2(x, floor=8):
    p = floor
    while p < x:
        p <<= 1
    return p


def batch_rows():
    """DN_INDEX_DEVICE_BATCH_ROWS: padded-row budget per dispatch (how
    many shards pack into one launch).  Clamped to a sane floor so a
    misconfigured knob cannot serialize into per-shard dispatches."""
    try:
        v = int(os.environ.get('DN_INDEX_DEVICE_BATCH_ROWS',
                               str(1 << 20)))
    except ValueError:
        v = 1 << 20
    return max(v, 1 << 12)


# -- lane routing -----------------------------------------------------------

def index_device_mode():
    """DN_INDEX_DEVICE: '0' pins the host bincount; 'auto' (default) and
    '1' follow the engine the caller chose."""
    v = os.environ.get('DN_INDEX_DEVICE', 'auto')
    return v if v in ('auto', '0', '1') else 'auto'


def lane_decision(engine):
    """('device'|'host', route) for this aggregation: the device
    engine forces the device lane unless DN_INDEX_DEVICE=0; the host
    engine ('vector') stays on the host."""
    if index_device_mode() == '0':
        return 'host', 'host: DN_INDEX_DEVICE=0'
    if engine == 'device':
        return 'device', 'device'
    return 'host', 'host: host engine'


# -- staging ----------------------------------------------------------------

def _stage_shard(inv_sl):
    """(local codes i64[n], ttable i64[nlocal], nlocal) for one
    shard's slice of the perm-ordered batch.  Local code = rank of the
    row's aggregate tuple in the shard's first-occurrence order; the
    ttable maps local -> this query's global segment id."""
    lu, first, linv = np.unique(inv_sl, return_index=True,
                                return_inverse=True)
    order = np.argsort(first, kind='stable')
    rankmap = np.empty(len(lu), dtype=np.int64)
    rankmap[order] = np.arange(len(lu), dtype=np.int64)
    local = rankmap[linv.reshape(-1)]
    return local, lu[order], len(lu)


def _pad_slot(local, w, nlocal, prow):
    """Pow2-pad one shard's staged pair: pad rows carry the sentinel
    local code `nlocal`, whose ttable slot points at the accumulator's
    last segment with weight 0, so no index falls outside the
    translation row or the accumulator (torch's gather and index_add_
    raise on the CPU and assert on CUDA where JAX would drop it)."""
    pl = np.full(prow, nlocal, dtype=np.int64)
    pl[:len(local)] = local
    pw = np.zeros(prow, dtype=np.int64)
    pw[:len(w)] = w
    return pl, pw


# -- the fold program -------------------------------------------------------

def _fold_program(lmat, wmat, ttabs, acc):
    """K7, the slot-packed scatter-add fold, in place: `lmat` and
    `wmat` are [S, prow] local codes and i64 weights of S shards,
    `ttabs` their [S, ptab] translation rows into the i64[pu]
    accumulator `acc`.  One gather through the translation rows, then
    one index_add_ of every slot's weights (integer atomics on CUDA:
    exact, independent of order).  Replaces the reference's jitted
    `take_along_axis` + `segment_sum` (dragnet_tpu/device_index.py
    `_fold_program`)."""
    import torch
    seg = torch.gather(ttabs, 1, lmat)
    acc.index_add_(0, seg.reshape(-1), wmat.reshape(-1))
    return acc


def _note_engagement(ndispatch, nshards, nrows, h2d_bytes):
    from .obs import metrics as obs_metrics
    _ENGAGE['dispatches'] += ndispatch
    _ENGAGE['shards'] += nshards
    _ENGAGE['rows'] += nrows
    _ENGAGE['h2d_bytes'] += h2d_bytes
    obs_metrics.inc('index_device_dispatches', ndispatch)
    obs_metrics.inc('index_device_shards', nshards)
    obs_metrics.inc('index_device_rows', nrows)
    obs_metrics.inc('index_device_h2d_bytes', h2d_bytes)
    if ndispatch:
        obs_metrics.set_gauge('index_device_shards_per_dispatch',
                              nshards / ndispatch)


def stats_doc():
    """The engagement snapshot: dispatches, shards, rows, upload bytes,
    the last lane and route, and the count of each route taken."""
    doc = dict(_ENGAGE, routes=dict(_ENGAGE['routes']))
    d = doc['dispatches']
    doc['shards_per_dispatch'] = round(doc['shards'] / d, 2) if d \
        else 0.0
    return doc


# -- execution --------------------------------------------------------------

def _device_fold(inv, w64, nuniq, shard_ctx, dev):
    """The staged, slot-packed, device-resident fold on `dev`.  Returns
    (acc i64[nuniq] host ndarray, dispatches, H2D bytes).
    `shard_ctx` is (sids i64[n] ascending, [(path, statkey)] per shard,
    query) from the stacked path, or None (one anonymous shard)."""
    import torch
    pu = _pow2(nuniq)
    sid = shard_ctx[0] if shard_ctx is not None \
        else np.zeros(len(inv), dtype=np.int64)
    nshards_total = (int(sid[-1]) + 1) if len(sid) else 0
    bounds = np.searchsorted(sid, np.arange(nshards_total + 1))

    staged = []                  # (prow, ttable, nlocal, local, w)
    for s in range(nshards_total):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if lo == hi:
            continue
        local, ttable, nlocal = _stage_shard(inv[lo:hi])
        staged.append((_pow2(hi - lo), ttable, nlocal, local, w64[lo:hi]))

    # pack by padded row count: pow2 slot ladder bounded by the
    # batch-rows budget (the reference's order and dispatch count)
    groups = {}
    for st in staged:
        groups.setdefault(st[0], []).append(st)
    budget = batch_rows()
    acc = torch.zeros(pu, dtype=torch.int64, device=dev)
    ndispatch = 0
    h2d_bytes = 0
    for prow in sorted(groups):
        todo = groups[prow]
        smax = max(1, min(_MAX_SLOTS, budget // prow))
        i = 0
        while i < len(todo):
            s = 1
            while s * 2 <= min(smax, len(todo) - i):
                s <<= 1
            chunk = todo[i:i + s]
            i += s
            ptab = _pow2(max(c[2] + 1 for c in chunk))
            ttabs = np.full((s, ptab), pu - 1, dtype=np.int64)
            lmat = np.empty((s, prow), dtype=np.int64)
            wmat = np.empty((s, prow), dtype=np.int64)
            for j, (_pr, tt, nl, local, w) in enumerate(chunk):
                ttabs[j, :nl] = tt
                lmat[j], wmat[j] = _pad_slot(local, w, nl, prow)
            h2d_bytes += lmat.nbytes + wmat.nbytes + ttabs.nbytes
            _fold_program(torch.from_numpy(lmat).to(dev),
                          torch.from_numpy(wmat).to(dev),
                          torch.from_numpy(ttabs).to(dev), acc)
            ndispatch += 1
    # ONE fetch: everything upstream stayed on the device
    out = acc[:nuniq].cpu().numpy()
    return out, ndispatch, h2d_bytes


def batched_sums(inv, weights, nuniq, shard_ctx=None, stage=None,
                 device=None):
    """Per-tuple weight sums through the batched device engine on
    `device`, as float64 (the host bincount's type), or None on the
    structural host routes: a segment count past the dense ceiling, or
    no rows.  A device failure raises: there is no host fallback."""
    from .engine import MAX_DENSE_SEGMENTS
    from .ops import resolve_device
    if nuniq > MAX_DENSE_SEGMENTS or len(inv) == 0:
        return None
    dev = resolve_device(device)
    acc, ndispatch, h2d_bytes = _device_fold(
        inv, weights.astype(np.int64), nuniq, shard_ctx, dev)
    nshards = len(shard_ctx[1]) if shard_ctx is not None else 1
    _note_engagement(ndispatch, nshards, len(inv), h2d_bytes)
    _ENGAGE['last_lane'] = 'device'
    if stage is not None:
        stage.bump_hidden('index device sums', 1)
    return acc.astype(np.float64)


def aggregate_weights(inv, weights, nuniq, stage=None, shard_ctx=None,
                      engine='device', device=None):
    """The stacked path's aggregation seam: the batched device engine
    per lane_decision, host np.bincount otherwise — byte-identical
    either way."""
    lane, route = lane_decision(engine)
    if lane == 'device':
        dense = batched_sums(inv, weights, nuniq, shard_ctx=shard_ctx,
                             stage=stage, device=device)
        if dense is not None:
            note_route(route)
            return dense
        route = 'host: no rows' if len(inv) == 0 \
            else 'host: segments past the dense ceiling'
    _ENGAGE['last_lane'] = 'host'
    note_route(route)
    return np.bincount(inv, weights=weights, minlength=nuniq)
