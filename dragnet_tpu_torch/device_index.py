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
  ladder, and with it the dispatch count, is the reference's.  A slot
  is either host arrays (stacked with the chunk's other host slots and
  uploaded in one copy) or a shard's own device tensors (a residency
  pin, or a fresh per-shard upload that gets pinned); the chunk's
  slots are packed on the card (`torch.stack`).
* **Residency (`dn serve`).**  With serve/residency.py armed, each
  shard's padded (local, weight) pair is pinned on the card under
  (`plan_signature`, `_shard_identity`, padded rows), and the final
  accumulator under the content digest of (inv, weights): an exact
  repeat answers from the pinned accumulator's fetched copy with no
  dispatch, and a different query over the same shards skips their
  uploads.  The epoch of index_query_mt.cache_epoch() retires every
  pin on an index write.
* **Device-resident fold, ONE fetch.**  The accumulator stays on the
  card through every dispatch (added in place; the reference re-feeds
  its jit output), and only `acc[:nuniq]` comes back, once, as float64
  — the host bincount's type, part of byte identity.  The accumulator
  is never written after that fetch, so it can be pinned.

Lane routing (`lane_decision`): DN_INDEX_DEVICE=0 pins the host
`np.bincount`; otherwise the device engine (DN_ENGINE=jax) forces the
device and the host engine stays on the host.  Under auto the lane is
audition-gated, as in the reference: a fresh persisted `iq:` verdict
that the device won this query shape sends it to the device; with no
verdict, a process that has already initialized CUDA auditions (both
paths run, timed, compared exactly, the verdict persisted in the
port's audition cache, device_scan.audition_cache_put), and so does a
`dn serve` whose residency is armed; otherwise the host answers — a
cold `dn query` never pays CUDA's start-up to ask.

Exactness: integer atomics are exact and independent of order, so the
i64 sums of the integer weights the stacked gate admits are bit-equal
to the host path.  There is no silent host fallback: on the device lane
a failed fold raises, and so does an audition whose device sums differ
from the host's.  The host bincount runs only on the structural
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
    'pinned_shard_hits': 0,
    'h2d_saved_bytes': 0,
    'auditions': 0,
    'last_audition': None,
    'last_lane': None,
    'last_route': None,
    'routes': {},
}
_MAX_SLOTS = 64


def _reset_engagement():
    """Test/bench hook: zero the per-process engagement snapshot."""
    for k in ('dispatches', 'shards', 'rows', 'h2d_bytes',
              'pinned_shard_hits', 'h2d_saved_bytes', 'auditions'):
        _ENGAGE[k] = 0
    _ENGAGE['last_lane'] = _ENGAGE['last_route'] = None
    _ENGAGE['last_audition'] = None
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


def _audition_key(nrows, nuniq):
    """Audition-cache key family for index queries: log2-bucketed
    (rows, uniques) — the two sizes that decide dispatch count and
    accumulator shape; the caller appends the device identity."""
    lr = _pow2(max(nrows, 1)).bit_length() - 1
    lu = _pow2(max(nuniq, 1)).bit_length() - 1
    return 'iq:r%d:u%d' % (lr, lu)


def _audition_warm(device):
    """Whether an auto-mode audition may touch the device here: only
    on CUDA, and only when the process has already initialized it (a
    scan, a build or the serve pre-warm before it) or a `dn serve`
    residency manager is armed."""
    import torch
    if device is None or torch.device(device).type != 'cuda':
        return False
    return torch.cuda.is_initialized() or _residency() is not None


def lane_decision(engine, nrows=0, nuniq=0, device=None):
    """('device'|'audition'|'host', route) for this aggregation: the
    device engine forces the device lane unless DN_INDEX_DEVICE=0; the
    host engine ('vector') stays on the host; auto follows a persisted
    `iq:` verdict for this shape, auditions in a process whose CUDA is
    warm, and otherwise stays on the host.  'audition' runs BOTH paths,
    compares them exactly, times them and persists the verdict."""
    if index_device_mode() == '0':
        return 'host', 'host: DN_INDEX_DEVICE=0'
    if engine == 'device':
        return 'device', 'device'
    if engine != 'auto':
        return 'host', 'host: host engine'
    from . import device_scan as mod_ds
    hint = mod_ds.audition_cache_shape_hint(_audition_key(nrows, nuniq))
    if hint is True:
        return 'device', 'device: audition verdict'
    if hint is False:
        return 'host', 'host: audition verdict'
    if _audition_warm(device):
        return 'audition', 'audition'
    return 'host', 'host: auto, device cold'


# -- shard identity ---------------------------------------------------------

_CATALOG_DIR_MEMO = {}


def _shard_identity(path, statkey):
    """Residency identity for one shard file: the integrity catalog's
    (size, crc32) when the tree publishes one — content identity that
    survives a byte-identical republish — else the handle cache's
    (mtime_ns, size, ino) statkey.  None when neither exists (the
    shard then stages fresh every query, which is always correct)."""
    from . import integrity as mod_integrity
    d = os.path.dirname(os.path.abspath(path))
    for root in (d, os.path.dirname(d)):
        has = _CATALOG_DIR_MEMO.get(root)
        if has is None:
            has = os.path.exists(mod_integrity.catalog_path(root))
            _CATALOG_DIR_MEMO[root] = has
        if not has:
            continue
        try:
            cat = mod_integrity.cached_catalog(root)
        except Exception:
            break
        rel = os.path.relpath(os.path.abspath(path), root)
        ent = cat.get(rel)
        if ent is not None:
            return ('crc', rel, int(ent[0]), int(ent[1]))
    if statkey is not None:
        return ('stat',) + tuple(statkey)
    return None


def plan_signature(query):
    """Digest of everything that determines a shard's staged tensors
    GIVEN its content: the composed filter inputs, the breakdown specs
    (bucketizer parameters included), and the time window.  Two
    queries with equal signatures stage byte-identical (local, weight)
    tensors from an identical shard."""
    import hashlib
    h = hashlib.blake2b(digest_size=12)
    h.update(repr((query.qc_filter, query.qc_breakdowns,
                   query.qc_before, query.qc_after)).encode())
    return h.hexdigest()


def _residency():
    """The serve-installed device residency manager, or None."""
    from .serve import residency as mod_residency
    return mod_residency.active()


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


def _note_engagement(ndispatch, nshards, nrows, pinned_hits,
                     h2d_bytes, h2d_saved):
    from .obs import metrics as obs_metrics
    _ENGAGE['dispatches'] += ndispatch
    _ENGAGE['shards'] += nshards
    _ENGAGE['rows'] += nrows
    _ENGAGE['pinned_shard_hits'] += pinned_hits
    _ENGAGE['h2d_bytes'] += h2d_bytes
    _ENGAGE['h2d_saved_bytes'] += h2d_saved
    obs_metrics.inc('index_device_dispatches', ndispatch)
    obs_metrics.inc('index_device_shards', nshards)
    obs_metrics.inc('index_device_rows', nrows)
    obs_metrics.inc('index_device_pinned_hits', pinned_hits)
    obs_metrics.inc('index_device_h2d_bytes', h2d_bytes)
    obs_metrics.inc('index_device_h2d_saved_bytes', h2d_saved)
    if ndispatch:
        obs_metrics.set_gauge('index_device_shards_per_dispatch',
                              nshards / ndispatch)


def stats_doc():
    """The engagement snapshot: dispatches, shards, rows, upload bytes,
    pinned shard hits and the upload bytes they saved, auditions (and the last one's verdict), the last lane and route,
    and the count of each route taken."""
    doc = dict(_ENGAGE, routes=dict(_ENGAGE['routes']))
    d = doc['dispatches']
    doc['shards_per_dispatch'] = round(doc['shards'] / d, 2) if d \
        else 0.0
    return doc


# -- execution --------------------------------------------------------------

def _device_fold(inv, w64, nuniq, shard_ctx, dev, info):
    """The staged, slot-packed, device-resident fold on `dev`.  Returns
    (acc i64[nuniq] host ndarray, dispatches, H2D bytes), and fills
    `info` with the accumulator tensor ('acc'), the pinned shard hits
    ('pinned_hits') and the H2D bytes they saved ('h2d_saved').
    `shard_ctx` is (sids i64[n] ascending, [(path, statkey)] per shard,
    query) from the stacked path, or None (one anonymous shard)."""
    import torch
    pu = _pow2(nuniq)
    if shard_ctx is not None:
        sid, pairs, query = shard_ctx
    else:
        sid = np.zeros(len(inv), dtype=np.int64)
        pairs, query = [(None, None)], None
    nshards_total = (int(sid[-1]) + 1) if len(sid) else 0
    bounds = np.searchsorted(sid, np.arange(nshards_total + 1))

    res = _residency()
    repoch = plan = None
    if res is not None:
        from . import index_query_mt as mod_iqmt
        repoch = mod_iqmt.cache_epoch()
        if query is not None:
            plan = plan_signature(query)

    # stage every non-empty shard: pinned device tensors where
    # residency has them, a fresh per-shard upload (then pinned) where
    # it can pin, host arrays (uploaded with their chunk) otherwise
    staged = []        # (prow, ttable, nlocal, device pair, host pair)
    pinned_hits = 0
    h2d_bytes = 0
    h2d_saved = 0
    for s in range(nshards_total):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if lo == hi:
            continue
        local, ttable, nlocal = _stage_shard(inv[lo:hi])
        prow = _pow2(hi - lo)
        key = None
        if plan is not None and s < len(pairs):
            ident = _shard_identity(*pairs[s]) \
                if pairs[s][0] is not None else None
            if ident is not None:
                key = ('iq-shard', plan, ident, prow)
            pinned = res.get_device(key, repoch)
            if pinned is not None:
                staged.append((prow, ttable, nlocal, pinned, None))
                pinned_hits += 1
                h2d_saved += prow * 16          # two i64 lanes
                continue
        pl, pw = _pad_slot(local, w64[lo:hi], nlocal, prow)
        if key is None:
            staged.append((prow, ttable, nlocal, None, (pl, pw)))
            continue
        pair = (torch.from_numpy(pl).to(dev), torch.from_numpy(pw).to(dev))
        h2d_bytes += pl.nbytes + pw.nbytes
        res.put_device(key, repoch, pair, nbytes=pl.nbytes + pw.nbytes)
        staged.append((prow, ttable, nlocal, pair, None))

    acc = torch.zeros(pu, dtype=torch.int64, device=dev)
    info.update(acc=acc, pinned_hits=pinned_hits, h2d_saved=h2d_saved)
    if not staged:
        return np.zeros(nuniq, dtype=np.int64), 0, 0

    # pack by padded row count: pow2 slot ladder bounded by the
    # batch-rows budget (the reference's order and dispatch count)
    groups = {}
    for st in staged:
        groups.setdefault(st[0], []).append(st)
    budget = batch_rows()
    ndispatch = 0
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
            for j, (_pr, tt, nl, _dev, _host) in enumerate(chunk):
                ttabs[j, :nl] = tt
            lmat, wmat, nbytes = _pack_slots(chunk, dev)
            h2d_bytes += nbytes + ttabs.nbytes
            _fold_program(lmat, wmat, torch.from_numpy(ttabs).to(dev),
                          acc)
            ndispatch += 1
    # ONE fetch: everything upstream stayed on the device
    out = acc[:nuniq].cpu().numpy()
    return out, ndispatch, h2d_bytes


def _pack_slots(chunk, dev):
    """The [S, prow] local-code and weight matrices of one dispatch on
    `dev`, and the bytes uploaded for them: the chunk's host slots in
    one copy each, its device slots stacked on the card."""
    import torch
    host = [c[4] for c in chunk if c[4] is not None]
    nbytes = 0
    if host:
        lm = np.stack([h[0] for h in host])
        wm = np.stack([h[1] for h in host])
        up_l = torch.from_numpy(lm).to(dev)
        up_w = torch.from_numpy(wm).to(dev)
        nbytes = lm.nbytes + wm.nbytes
        if len(host) == len(chunk):
            return up_l, up_w, nbytes
    rows_l, rows_w = [], []
    k = 0
    for c in chunk:
        if c[3] is not None:
            rows_l.append(c[3][0])
            rows_w.append(c[3][1])
        else:
            rows_l.append(up_l[k])
            rows_w.append(up_w[k])
            k += 1
    return torch.stack(rows_l), torch.stack(rows_w), nbytes


def batched_sums(inv, weights, nuniq, shard_ctx=None, stage=None,
                 device=None, audition=False):
    """Per-tuple weight sums through the batched device engine on
    `device`, as float64 (the host bincount's type), or None on the
    structural host routes: a segment count past the dense ceiling, or
    no rows.  A device failure raises: there is no host fallback.  With
    `audition=True` the host bincount runs too: both are timed, the
    sums compared exactly (a difference raises), and the verdict — the
    device won when its rate beat the host's — persists under the
    `iq:` family for the next auto query.  With residency armed
    (`dn serve`), an exact repeat answers from the pinned accumulator
    without a dispatch, and a computed accumulator is pinned."""
    import time
    from .engine import MAX_DENSE_SEGMENTS
    from .ops import resolve_device
    if nuniq > MAX_DENSE_SEGMENTS or len(inv) == 0:
        return None
    dev = resolve_device(device)
    w64 = weights.astype(np.int64)
    res = _residency()
    rkey = repoch = None
    if res is not None:
        from . import index_query_mt as mod_iqmt
        from .serve import residency as mod_residency
        rkey = mod_residency.content_key('iq-acc', (inv, w64),
                                         (_pow2(nuniq), nuniq))
        repoch = mod_iqmt.cache_epoch()
        pinned = res.get(rkey, repoch)
        if pinned is not None:
            _ENGAGE['last_lane'] = 'device'
            if stage is not None:
                stage.bump_hidden('index device sums', 1)
            return pinned.copy()
    t0 = time.monotonic()
    info = {}
    acc, ndispatch, h2d_bytes = _device_fold(inv, w64, nuniq, shard_ctx,
                                             dev, info)
    device_s = time.monotonic() - t0
    nshards = len(shard_ctx[1]) if shard_ctx is not None else 1
    _note_engagement(ndispatch, nshards, len(inv), info['pinned_hits'],
                     h2d_bytes, info['h2d_saved'])
    _ENGAGE['last_lane'] = 'device'
    if stage is not None:
        stage.bump_hidden('index device sums', 1)
    out = acc.astype(np.float64)
    if audition:
        _audition(inv, weights, nuniq, out, device_s, dev)
    if res is not None:
        # pin the final accumulator (no fold writes it again) and its
        # one fetched copy: an exact repeat answers with no transfer
        res.put(rkey, repoch, info['acc'], out, h2d_bytes=h2d_bytes)
        return out.copy()
    return out


def _audition(inv, weights, nuniq, dense, device_s, dev):
    """Time the host bincount against the device fold's `device_s`,
    compare the sums exactly and persist the verdict."""
    import time
    from . import device_scan as mod_ds
    from .obs import metrics as obs_metrics
    t1 = time.monotonic()
    ref = np.bincount(inv, weights=weights, minlength=nuniq)
    host_s = max(time.monotonic() - t1, 1e-9)
    rate_d = len(inv) / max(device_s, 1e-9)
    rate_h = len(inv) / host_s
    equal = np.array_equal(dense, ref)
    key = '%s@%s' % (_audition_key(len(inv), nuniq),
                     mod_ds._backend_id(dev))
    _ENGAGE['auditions'] += 1
    obs_metrics.inc('index_device_auditions', 1)
    if not equal:
        # a wrong device sum is a fault, never a quiet host answer
        _ENGAGE['last_audition'] = {'key': key, 'equal': False}
        raise RuntimeError('index query audition: device sums differ '
                           'from the host bincount (%s)' % key)
    won = bool(rate_d > rate_h)
    mod_ds.audition_cache_put(key, won, device_rate=rate_d,
                              host_rate=rate_h)
    _ENGAGE['last_audition'] = {'key': key, 'equal': True, 'won': won,
                                'device_rate': rate_d, 'host_rate': rate_h}


def aggregate_weights(inv, weights, nuniq, stage=None, shard_ctx=None,
                      engine='device', device=None):
    """The stacked path's aggregation seam: the batched device engine
    per lane_decision, host np.bincount otherwise — byte-identical
    either way."""
    lane, route = lane_decision(engine, len(inv), nuniq, device)
    if lane != 'host':
        dense = batched_sums(inv, weights, nuniq, shard_ctx=shard_ctx,
                             stage=stage, device=device,
                             audition=(lane == 'audition'))
        if dense is not None:
            note_route(route)
            return dense
        route = 'host: no rows' if len(inv) == 0 \
            else 'host: segments past the dense ceiling'
    _ENGAGE['last_lane'] = 'host'
    note_route(route)
    return np.bincount(inv, weights=weights, minlength=nuniq)
