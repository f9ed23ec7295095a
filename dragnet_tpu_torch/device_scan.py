"""Device-resident scan, dense mode: the per-batch pipeline after the
parse runs on a torch device.

Counterpart of dragnet_tpu/device_scan.py `DeviceScan` (dense mode):

    host:    C++ parse -> tagged columns -> one-pass batch stats ->
             upload (dtype-narrowed columns + small lookup tables;
             inputs the stats prove constant are synthesized on
             device instead of uploaded — the sticky upload profile)
    device:  the scan program (K2, scan_program.py and its kernel
             ops/csrc/scan_body.cu, one launch a batch): predicate
             table-gathers + numeric compares -> ternary and/or fold ->
             date-error & time-bounds masks -> p2/linear bucketize ->
             mixed-radix key fusion -> the weights added into the
             resident accumulator, or the fused key handed to the
             one-hot kernel K1 (ops/cuda_kernels.py, adding into it),
             plus the first-occurrence min and the stage counters

Each batch folds straight into a device-RESIDENT i64 accumulator
(dense/counters add; first-occurrence keys take a running min over
batch_base + row), so a scan fetches once per epoch, not once per
batch.  On the CPU the program runs as its plain torch version
(scan_program.scan_body_ref).  Emission order is preserved exactly:
the accumulated first-occurrence key (batch_index << 32 | row) sorts
keys by batch, then by first row within the batch, which is the order
the host engine inserts them.

Exactness contract: everything uploaded is integer (narrowed columns,
i32 weights) or a table gather, and every device sum is integer, so the
arithmetic is exact and independent of the order of CUDA's atomics.
A batch that cannot be represented exactly (non-integral weights or
values, out-of-i32-range numbers, array-typed values in filter
fields, ...) takes the host engine for that batch, after the device
buffer is flushed so insertion order survives.

A key space beyond the dense accumulator (MAX_DENSE_SEGMENTS) runs the
SPARSE program instead: fused i64 keys sort-merged into a device-resident
compacted set (keys, weight sums, first occurrence) of bounded capacity,
grown by a host-side guard that flushes before a batch could overflow it.

DeviceScanStack folds N metric scans (a `dn build`) per batch over one
staged input dict, so a column several metrics read uploads once.

Engagement (the reference's, with its constants): a DeviceScan may
start on the host engine and escalate past ESCALATE_RECORDS once its
backend probe passes, and de-escalate for good when a timed probation
window shows the device slower than the host rate seen before it.
Forced mode (DN_ENGINE=jax, the port's engine='device') escalates at
once and has no probation; its probe raises on failure.  AutoDeviceScan
(DN_ENGINE=auto on a CUDA device) starts on the host by design: its
probe runs on a background thread, and on the multithreaded host path
(scan_mt) the device takes the stream over only after it wins a shadow
audition on copies of live batches.  Verdicts persist per (query shape,
backend) in the port's own audition cache (`audition_cache_get/put`).

Pipelined dispatch (the reference's, redesigned for CUDA): a batch's
per-record inputs are packed into a reused page-locked slot of the
scan's staging ring (_StagingRing) and cross in one non_blocking copy
on the ring's copy stream, which the compute stream waits on by event;
each dispatched batch leaves a CUDA event as its completion token, and
the host blocks only on the token from pipeline_depth() dispatches back
(_note_dispatch).  Late in the stream (PREFETCH_PROGRESS) the epoch's
fetch is issued early into page-locked host memory (_prefetch_flush);
it drains, in order, at the next flush (_drain_pending), through the
flush's own fetch and emit (_take_epoch, _emit_epoch).  Every barrier
is the scan's own: an event on its compute stream, never the whole
device.
"""

import collections
import os
import threading
import time

import numpy as np
import torch

from . import jsvalues as jsv
from . import log as mod_log
from . import native as mn
from . import query as mod_query
from . import engine as mod_engine
from .engine import (VectorScan, NativeColumns, MAX_DENSE_SEGMENTS,
                     _native_str_trans)
from .errors import DNError
from . import scan_program
from .ops import resolve_device
from .ops import cuda_kernels
# numeric-row plans: outcome of <leaf op const> for an exact-int32 row
from .scan_program import (NUM_FALSE, NUM_TRUE, NUM_EQ, NUM_NE, NUM_LE,
                           NUM_GE)

I32MIN = -(2 ** 31)
I32MAX = 2 ** 31 - 1
I64MAX = 2 ** 63 - 1
I16MIN = -(2 ** 15)
I16MAX = 2 ** 15 - 1

# device-resident sparse set (high-cardinality mode): initial capacity,
# growth ceiling.  24 bytes/slot of device memory; the host-side
# pressure guard flushes + grows before a batch could overflow the set
SPARSE_CAP0 = 1 << 20
SPARSE_CAP_MAX = 1 << 23

LOG = mod_log.get('device-scan')

# calls of the sparse fold (torch ops, no hand kernel): a run can show
# that its batches went through the sparse program
sparse_folds = {'fold_sparse': 0}

# dispatch barrier interval: a hard backstop on how far the host can run
# ahead of the device beyond the pipeline window (the window below is
# the working bound)
SYNC_EVERY_BATCHES = 32


def pipeline_depth():
    """How many dispatched device batches may be in flight before the
    host blocks on the oldest (DN_DEVICE_PIPELINE_DEPTH, default 2:
    double buffering, the host stages and uploads batch N+1 while the
    device folds batch N).  Malformed values read as the default here;
    config.device_config is where they are rejected."""
    v = os.environ.get('DN_DEVICE_PIPELINE_DEPTH', '')
    if v:
        try:
            return max(1, int(v))
        except ValueError:
            pass
    return 2


def _note_h2d(nbytes):
    """Host->device bytes of per-record inputs (the always-on
    device_h2d_bytes counter)."""
    if nbytes:
        from .obs import metrics as obs_metrics
        obs_metrics.inc('device_h2d_bytes', int(nbytes))


def uses_kernel(staged):
    """Whether a staged batch folds through the one-hot kernel (K1)
    rather than index_add_ (never in sparse mode): the one decision
    _fold_staged and the benchmark's capture share."""
    n, profile, caps, ns, total_w = staged
    return not profile[-1] and bool(caps) and \
        cuda_kernels.should_use(ns, total_w)


def _align(nbytes, quantum=256):
    return (nbytes + quantum - 1) // quantum * quantum


class _Slot(object):
    __slots__ = ('host', 'host_np', 'dev', 'nbytes', 'copied', 'consumed')

    def __init__(self):
        self.host = self.host_np = self.dev = None
        self.nbytes = 0
        self.copied = None      # event: the slot's last copy is done
        self.consumed = None    # event: the fold that read it is done


class _StagingRing(object):
    """Reused staging for the per-record inputs of one scan (or of one
    DeviceScanStack): a ring of slots, each a host buffer and a device
    buffer of one capacity.  A batch's per-record arrays are packed into
    one slot, each at a 256-byte-aligned offset, and cross in ONE copy;
    the fold reads typed views of the slot's device buffer.

    On CUDA the host buffer is page-locked and the copy is non_blocking
    on the ring's own copy stream, so it neither holds the host thread
    nor queues behind the previous batch's fold on the compute stream;
    the compute stream waits on the copy's event.  A slot is rewritten
    only after its previous copy completed (the host waits on that
    event: the DMA reads the page-locked buffer until then) and after
    the fold that read its device buffer completed (the copy stream
    waits on that fold's event), so nothing in flight is overwritten at
    any pipeline depth.  A device buffer is allocated on the compute
    stream (its owner in the caching allocator) and marked as used on
    the copy stream (record_stream), and the copy stream waits once on
    the compute stream after each allocation, since the block may have
    served earlier compute work.

    On the CPU the same packing and copy run synchronously, with no
    streams and no events, so the CPU tests exercise the layout."""

    def __init__(self, device, nslots):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.copy_stream = torch.cuda.Stream(device) if self.cuda \
            else None
        self.slots = [_Slot() for _ in range(max(2, nslots))]
        self.next = 0

    def _alloc(self, slot, nbytes, compute):
        """(Re)allocate a slot at `nbytes`.  The caller has waited for
        its last copy; its device buffer's readers are on the compute
        stream, which orders the block's reuse."""
        slot.host = slot.host_np = slot.dev = None
        try:
            host = torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=self.cuda)
            if self.cuda and not host.is_pinned():
                raise RuntimeError('host staging buffer is not page-locked')
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            if self.cuda:
                dev.record_stream(self.copy_stream)
                self.copy_stream.wait_stream(compute)
        except RuntimeError as e:
            raise DNError('device staging: allocating %d bytes failed'
                          % nbytes, cause=e)
        slot.host, slot.host_np, slot.dev = host, host.numpy(), dev
        slot.nbytes = nbytes
        slot.consumed = None

    def stage(self, inputs, cap0, compute):
        """Pack the per-record numpy arrays of `inputs` into the next
        slot and start their copy.  Returns (args, nbytes, slot): args
        maps every key to a device tensor (device-resident tables pass
        through), nbytes is the per-record bytes copied, slot is what
        release() takes after the fold (None when nothing was copied).
        A slot's capacity is `cap0` rows, doubled until the batch fits:
        only the batch's own rows are copied.  (The reference pads a
        batch up to a floor, _pad_floor, so its compiled programs see
        few shapes; eager torch compiles nothing, so the port pads
        nothing and has no floor.)"""
        args = {}
        layout = []
        end = 0
        rows = 0
        for k, v in inputs.items():
            if isinstance(v, np.ndarray):
                v = np.ascontiguousarray(v).reshape(-1)
                layout.append((k, v, end))
                end += _align(v.nbytes)
                rows = max(rows, len(v))
            else:
                args[k] = v
        if not layout:
            return args, 0, None
        cap = max(1, int(cap0))
        while cap < rows:
            cap <<= 1
        need = sum(_align(v.itemsize * cap) for _, v, _ in layout)
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot.copied is not None:
            slot.copied.synchronize()
            slot.copied = None
        if slot.nbytes < need:
            self._alloc(slot, need, compute)
        hb = slot.host_np
        nbytes = 0
        for _, v, off in layout:
            hb[off:off + v.nbytes] = v.view(np.uint8)
            nbytes += v.nbytes
        try:
            if self.cuda:
                cs = self.copy_stream
                with torch.cuda.stream(cs):
                    if slot.consumed is not None:
                        cs.wait_event(slot.consumed)
                    slot.dev[:end].copy_(slot.host[:end], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(cs)
                compute.wait_event(ev)
                slot.copied = ev
            else:
                slot.dev[:end].copy_(slot.host[:end])
        except RuntimeError as e:
            raise DNError('device staging: the input copy failed', cause=e)
        if self.cuda and slot.host.is_pinned():
            from .obs import metrics as obs_metrics
            obs_metrics.inc('device_h2d_pinned_bytes', nbytes)
        for k, v, off in layout:
            args[k] = slot.dev[off:off + v.nbytes].view(
                torch.from_numpy(v[:0]).dtype)
        return args, nbytes, slot

    def release(self, slot, compute):
        """After the fold that read `slot` was queued: its completion
        token, an event on the compute stream (None on the CPU), which
        also frees the slot's device buffer for the copy stream."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(compute)
        if slot is not None:
            slot.consumed = ev
        return ev


def _issue_async(tensors):
    """Start the device->host copies of `tensors`: each into a
    page-locked host tensor with non_blocking=True on the current
    stream, then one event after them.  Returns (host tensors, event);
    on the CPU the tensors are their own host copies and the event is
    None.  A copy that fails on the card raises DNError: there is no
    fallback to a synchronous or pageable fetch."""
    if not tensors or tensors[0].device.type != 'cuda':
        return list(tensors), None
    try:
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        ev = torch.cuda.Event()
        ev.record()
    except RuntimeError as e:
        raise DNError('device fetch: the async copy failed', cause=e)
    return hosts, ev


def _wait_fetched(hosts, token):
    """Numpy arrays of an _issue_async fetch, once its event is done."""
    if token is not None:
        token.synchronize()
    return [h.numpy() for h in hosts]


def _fetch(tensors):
    """One synchronous fetch of several device tensors: the copies are
    issued together and awaited on one event."""
    return _wait_fetched(*_issue_async(list(tensors)))


def _rate_field(r):
    """Rates for log records: None when unknown, the float itself when
    non-finite (round(inf) raises)."""
    if r is None:
        return None
    try:
        import math
        return round(r) if math.isfinite(r) else r
    except (TypeError, ValueError):
        return r


# -- wedge armor: probe deadlines -------------------------------------------

def probe_deadline_s():
    """Deadline (seconds) for first-contact device operations —
    DN_DEVICE_PROBE_TIMEOUT, the reference's knob and default."""
    try:
        return float(os.environ.get('DN_DEVICE_PROBE_TIMEOUT', '420'))
    except ValueError:
        return 420.0


def run_with_deadline(fn, seconds, what):
    """Run `fn` on a daemon thread and wait at most `seconds`.  Returns
    ('ok', result), ('error', exception), or ('timeout', None).  A hung
    device call hangs the daemon thread, not the caller; the abandoned
    thread is leaked deliberately (a stuck device op cannot be
    cancelled, and process exit does not join daemons)."""
    box = []
    done = threading.Event()

    def _go():
        try:
            box.append(('ok', fn()))
        except BaseException as e:
            box.append(('error', e))
        finally:
            done.set()

    t = threading.Thread(target=_go, daemon=True,
                         name='dn-deadline-%s' % what)
    t.start()
    done.wait(seconds)
    if not box:
        return ('timeout', None)
    return box[0]


# -- audition verdict cache --------------------------------------------------

AUDITION_FILE = 'dn_torch_auditions.json'


def _audition_cache_file():
    """Path of the port's persisted audition-verdict cache, or None
    when disabled (DN_AUDITION_CACHE=0, the reference's switch).  Its
    own directory (DN_TORCH_CACHE_DIR, default
    ~/.cache/dragnet_tpu_torch) AND its own file name: the port never
    reads or overwrites the JAX package's dn_auditions.json, even when
    both directories are pointed at the same place."""
    if os.environ.get('DN_AUDITION_CACHE', '1') == '0':
        return None
    base = os.environ.get('DN_TORCH_CACHE_DIR') or os.path.join(
        os.path.expanduser('~'), '.cache', 'dragnet_tpu_torch')
    return os.path.join(base, AUDITION_FILE)


def _audition_ttl_s():
    """How long a persisted verdict stays trusted (DN_AUDITION_TTL_S,
    default one day): rigs change, so verdicts age out."""
    try:
        return float(os.environ.get('DN_AUDITION_TTL_S', '86400'))
    except ValueError:
        return 86400.0


def _backend_id(device=None):
    """Identity of the device for audition-cache keys: torch, the CUDA
    device's name and compute capability ('torch/cpu' on the CPU).  A
    verdict measured on one card must not route another.  Initializes
    CUDA: call it only after the probe passed."""
    try:
        dev = torch.device('cuda' if device is None else device)
        if dev.type != 'cuda':
            return 'torch/%s' % dev.type
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        return 'torch/%s sm_%d%d' % (torch.cuda.get_device_name(idx),
                                     major, minor)
    except Exception:
        return 'unknown'


def audition_cache_get(key):
    """The cached verdict for `key`: True (device won), False (device
    lost), or None (no fresh entry).  All failures read as None — the
    cache only ever skips work, never adds requirements."""
    ent = _audition_entries_raw()[1].get(key)
    return None if ent is None else bool(ent['won'])


def audition_cache_put(key, won, device_rate=None, host_rate=None):
    """Persist an audition (or probation-crossover) verdict.  Expired
    entries are pruned on write; the file is swapped atomically
    (tmp+rename) so concurrent runs never read torn JSON, and the
    read-modify-write runs under a `.lock` sidecar flock so concurrent
    writers cannot drop each other's verdicts.  Best-effort: an
    unwritable cache directory never blocks the decision already made."""
    path = _audition_cache_file()
    if path is None:
        return
    import json
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lockf = None
        try:
            lockf = open(path + '.lock', 'a')
            import fcntl
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
        except Exception:
            pass        # best-effort on filesystems without flock
        try:
            try:
                with open(path) as f:
                    data = json.load(f)
                if not isinstance(data, dict):
                    data = {}
            except Exception:
                data = {}
            now = time.time()
            ttl = _audition_ttl_s()
            data = {k: v for k, v in data.items()
                    if isinstance(v, dict)
                    and now - float(v.get('ts', 0)) <= ttl}
            data[key] = {'won': bool(won), 'ts': now,
                         'device_rate': _rate_field(device_rate),
                         'host_rate': _rate_field(host_rate)}
            tmp = '%s.%d.%d' % (path, os.getpid(), threading.get_ident())
            try:
                with open(tmp, 'w') as f:
                    json.dump(data, f)
                os.rename(tmp, path)
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        finally:
            if lockf is not None:
                lockf.close()       # releases the flock
    except Exception:
        pass


def _audition_entries_raw():
    """(path, fresh entries) of the persisted audition cache; failures
    read as empty."""
    path = _audition_cache_file()
    if path is None:
        return None, {}
    import json
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            return path, {}
    except Exception:
        return path, {}
    # wall clock on purpose: `ts` persists across processes
    now = time.time()
    ttl = _audition_ttl_s()
    return path, {k: v for k, v in data.items()
                  if isinstance(v, dict) and 'won' in v
                  and now - float(v.get('ts', 0)) <= ttl}


def audition_cache_entries():
    """(path, fresh entries, fresh wins) of the persisted audition
    cache; (None, 0, 0) when disabled."""
    path, data = _audition_entries_raw()
    if path is None:
        return None, 0, 0
    wins = sum(1 for v in data.values() if v.get('won'))
    return path, len(data), wins


def audition_cache_shape_hint(shape):
    """Whether ANY backend ever auditioned this query shape: True when
    some fresh entry for `shape` won, False when entries exist and all
    lost, None when never auditioned.  A heuristic only (it tunes how
    eagerly auto escalates); the full shape+backend key still gates the
    takeover itself."""
    _, data = _audition_entries_raw()
    prefix = shape + '@'
    verdicts = [bool(v.get('won')) for k, v in data.items()
                if k.startswith(prefix)]
    if not verdicts:
        return None
    return True if any(verdicts) else False


def _pow2(x):
    p = 8
    while p < x:
        p <<= 1
    return p


def numeric_leaf_plan(op, const):
    """(mode, threshold) evaluating `value <op> const` for values that
    are exact int32 numbers, with JS coercion semantics for const.
    Returns None when no exact integer plan exists."""
    import math
    if isinstance(const, bool):
        cf = 1.0 if const else 0.0
    elif isinstance(const, (int, float)):
        cf = jsv.as_float(const)
    elif isinstance(const, str):
        # number-vs-string compares coerce the string in JS (both for
        # loose == and for relational operators)
        cf = jsv.to_number(const)
    else:
        return None
    if cf != cf:  # NaN: == false, != true, relational false
        if op == 'ne':
            return (NUM_TRUE, 0)
        return (NUM_FALSE, 0)
    if op in ('eq', 'ne'):
        if math.isinf(cf) or cf != math.floor(cf) or \
                not (I32MIN <= cf <= I32MAX):
            return ((NUM_FALSE, 0) if op == 'eq' else (NUM_TRUE, 0))
        t = int(cf)
        return ((NUM_EQ, t) if op == 'eq' else (NUM_NE, t))
    if math.isinf(cf):
        big = cf > 0
        if op in ('lt', 'le'):
            return (NUM_TRUE, 0) if big else (NUM_FALSE, 0)
        return (NUM_FALSE, 0) if big else (NUM_TRUE, 0)
    f = math.floor(cf)
    if op == 'lt':
        t = int(f) - 1 if cf == f else int(f)   # v < c  <=>  v <= t
        mode = NUM_LE
    elif op == 'le':
        t = int(f)                              # v <= floor(c)
        mode = NUM_LE
    elif op == 'gt':
        t = int(f) + 1                          # v > c  <=>  v >= t
        mode = NUM_GE
    else:  # ge
        t = int(f) if cf == f else int(f) + 1   # v >= ceil(c)
        mode = NUM_GE
    if mode == NUM_LE:
        if t >= I32MAX:
            return (NUM_TRUE, 0)
        if t < I32MIN:
            return (NUM_FALSE, 0)
    else:
        if t <= I32MIN:
            return (NUM_TRUE, 0)
        if t > I32MAX:
            return (NUM_FALSE, 0)
    return (mode, t)


class _KeyPlan(object):
    """Per-breakdown device plan + its growing window/capacity state."""

    __slots__ = ('kind', 'name', 'field', 'step', 'lo', 'cap',
                 'host_translate', 'column', 'window_set')

    def __init__(self, kind, name, field=None, step=None, column=None):
        self.kind = kind          # 'str' | 'p2' | 'lin'
        self.name = name
        self.field = field or name
        self.step = step
        self.column = column      # engine StringColumn for 'str'
        self.lo = 0
        self.cap = 8 if kind != 'p2' else 32
        self.host_translate = False
        self.window_set = False   # 'lin' window anchored to data yet?

    def sig(self):
        return (self.kind, self.lo, self.cap, self.step,
                self.host_translate)


class DeviceScan(VectorScan):
    """VectorScan whose eligible batches execute fully on the device
    (`device`: a torch device or its name; CUDA unless the caller asks
    for the CPU).

    ESCALATE_RECORDS: batches are processed by the host engine until
    this many records have been seen; 0 means device-first.

    REQUIRE_ACCELERATOR: when True the probe additionally requires a
    CUDA device (auto mode); forced mode runs on whatever device it was
    given, the CPU included.

    PROBATION_RECORDS: when nonzero, the first device batch is synced
    out, then this many device-processed records (or PROBATION_SECONDS,
    whichever trips first) are timed against the host rate observed
    before escalation; a slower device de-escalates to the host engine
    for the rest of the scan."""

    ESCALATE_RECORDS = 0
    REQUIRE_ACCELERATOR = False
    PROBATION_RECORDS = 0
    PROBATION_SECONDS = 0.25
    # whether the datasource should run the MT host executor and let
    # this scanner take the stream over mid-flight (auto mode only;
    # forced mode owns the stream from the first batch)
    AUTO_STREAM = False

    # accumulators at least this large are compacted ON DEVICE before
    # the fetch (argsort by first occurrence, gather occurred segments)
    COMPACT_MIN_SEGMENTS = 16384
    # speculative compacted-fetch width: one round trip when the
    # occurred count fits (the norm); a larger refetch otherwise
    COMPACT_K = 1 << 16
    # whether DeviceScanStack may fold this scan with its siblings
    STACKABLE = True

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None):
        dev = resolve_device(device)
        VectorScan.__init__(self, query, time_field, pipeline,
                            ds_filter=ds_filter, device=dev)
        # input-key namespace: '' standalone; DeviceScanStack assigns
        # 'm<i>_' so per-scan inputs (leaf tables, translate tables,
        # synth columns) coexist in one merged inputs dict while
        # parser-derived columns stay shared across metrics
        self._pfx = ''
        self._disabled = False
        self._records_seen = 0
        self._backend_ok = None
        self._host_records = 0
        self._host_rate = None
        self._t0 = None
        self._probation = None    # None=not started, tuple=timing, False=done
        self._escalated = False
        self._probe_thread = None
        self._probe_result = None
        self._probe_retries = 0   # re-probes after a clean refusal
        self.probe_status = None  # 'ok'/'refused'/'error'/'timeout'
        self._progress = None     # (bytes_done, bytes_total) from stream
        self._shadow_ctx = None   # set by enable_shadow (MT path)
        self._shadow = None
        # the route this scan took, for whoever ran it to read
        # (route_doc): escalation, audition, probation, device batches
        self.route = {'escalated_at': None, 'device_batches': 0,
                      'cached_verdict': None, 'audition': None,
                      'probation': None}
        self._sticky = None       # upload-profile state (_stage_device)
        self._mesh_rows = None    # per-record input keys (_run_staged)
        # when True, _run_staged records (inputs, staged, use_kernel) on
        # self.captured before the upload: the kernel-resident benchmark
        # (devbench.py) replays the production fold on that batch
        self.capture_next = False
        self.captured = None
        self._sparse_cap = SPARSE_CAP0
        self._sparse_ub = 0       # unique-count upper bound this epoch
        self._plans = None        # built from the query
        self._epoch_sig = None
        # device-resident (dense, first, cvec), or in sparse mode
        # (keys, wsum, first, cvec, stats=[nuniq, overflow])
        self._acc = None
        self._acc_meta = None     # epoch ('caps', 'cols', 'ns', ...)
        self._acc_batch = 0       # batches folded into the acc
        # the pipelined dispatch: the staging ring (made at the first
        # device batch), the stream the scan's device work runs on (the
        # driving thread's current stream), the in-flight completion
        # tokens, and prefetched epochs awaiting their ordered drain
        self._ring = None
        self._compute = None
        self._pipe = collections.deque()
        self._prefetched = False
        self._pending_flush = []
        self._leaf_list = []      # [(key, Leaf)] in stable order
        self._leaf_tables = {}    # leaf idx -> (host_len, device tensor)
        # compiled scan programs (scan_program.compile_program) by plan
        # signature, upload profile, caps and output mode, and K2's i32
        # fused-key scratch for K1, per device
        self._programs = {}
        self._key_bufs = {}
        self._trans_dev = {}      # plan name -> (host_len, device tensor)
        self._num_plans = []
        self._counter_spec = None
        self._synth_names = None
        self._build_static()

    # -- static (per-query) plan -------------------------------------------

    def _build_static(self):
        """Decide, once, whether this query can have a device program
        at all, and precompute everything that doesn't depend on data."""
        synth_names = set(s['name'] for s in self.synthetic)
        plans = []
        for b in self.query.qc_breakdowns:
            name = b['name']
            if name in self.query.qc_bucketizers:
                bz = self.query.qc_bucketizers[name]
                if isinstance(bz, mod_query.P2Bucketizer):
                    kind, step = 'p2', None
                else:
                    step = bz.step
                    if not (isinstance(step, int) and
                            not isinstance(step, bool) and
                            1 <= step <= I32MAX):
                        self._disabled = True
                        return
                    kind = 'lin'
                if name in synth_names:
                    field = next(s['field'] for s in self.synthetic
                                 if s['name'] == name)
                    plans.append(_KeyPlan(kind, name, field='\0synth:' +
                                          name, step=step))
                else:
                    plans.append(_KeyPlan(kind, name, step=step))
            else:
                if name in synth_names:
                    # synthetic (date) field used as a plain string key:
                    # host path stringifies parsed seconds; rare — host
                    self._disabled = True
                    return
                plans.append(_KeyPlan('str', name,
                                      column=self.string_columns[name]))
        self._plans = plans
        self._synth_names = synth_names

        for pred in (self.ds_pred, self.user_pred):
            if pred is None:
                continue
            for key, leaf in pred.leaves.items():
                if key not in [k for k, _ in self._leaf_list]:
                    self._leaf_list.append((key, leaf))
        for _, leaf in self._leaf_list:
            self._num_plans.append(numeric_leaf_plan(leaf.op, leaf.const))

        # counters, in the exact order the host engine bumps them
        # (always=False counters are only bumped when nonzero, matching
        # the host's conditional bumps)
        spec = []
        if self.ds_pred is not None:
            s = self.ds_stage
            spec += [(s, 'ninputs', True), (s, 'nfailedeval', False),
                     (s, 'nfilteredout', False), (s, 'noutputs', True)]
        if self.user_pred is not None:
            s = self.user_stage
            spec += [(s, 'ninputs', True), (s, 'nfailedeval', False),
                     (s, 'nfilteredout', False), (s, 'noutputs', True)]
        if self.synthetic:
            s = self.synth_stage
            spec += [(s, 'ninputs', True), (s, 'undef', False),
                     (s, 'baddate', False), (s, 'noutputs', True)]
        if self.time_bounds is not None:
            s = self.time_stage
            spec += [(s, 'ninputs', True), (s, 'nfilteredout', False),
                     (s, 'noutputs', True)]
        spec.append((self.aggr.stage, 'ninputs', True))
        spec.append((self.aggr.stage, 'nnonnumeric', False))
        # records aggregated through the unbounded-cardinality path
        # (always 0 in dense mode; kept so the order matches the host)
        spec.append((self.aggr.stage, 'nspillrecords', False))
        self._counter_spec = spec

    # -- per-batch entry ---------------------------------------------------

    def _process(self, provider, weights, alive=None):
        if self._t0 is None:
            self._t0 = time.monotonic()
        n = provider.n
        self._records_seen += n
        if not self._disabled and \
                self._records_seen > self._escalate_records() and \
                self._engage_device():
            if self._try_device(provider, weights, alive):
                self._after_device_batch(n)
                return
        self._flush()
        self._host_records += n
        VectorScan._process(self, provider, weights, alive=alive)

    # once the stream is this far along, the epoch so far is detached
    # and its fetch issued asynchronously, overlapping the fetch with
    # the rest of the stream
    PREFETCH_PROGRESS = 0.7

    def set_progress(self, bytes_done, bytes_total):
        """Stream-progress hook (the file datasource reports bytes
        consumed vs total): lets auto mode estimate remaining work
        before committing to a device switch, and triggers the one-time
        async flush prefetch late in the stream (DN_PREFETCH=0
        disables it)."""
        self._progress = (bytes_done, bytes_total)
        if not self._prefetched and self._acc is not None and \
                bytes_total > 0 and \
                bytes_done >= self.PREFETCH_PROGRESS * bytes_total:
            self._prefetched = True
            if os.environ.get('DN_PREFETCH', '1') != '0':
                self._prefetch_flush()

    def _prefetch_flush(self):
        """Detach the current epoch and issue its fetch now
        (_take_epoch: compacted on the device where large, copied into
        page-locked host memory); accumulation continues in a fresh
        accumulator and the epoch drains, in order, at the next _flush.
        On the card a failure raises DNError (the reference logs it and
        stays synchronous)."""
        try:
            epoch = self._take_epoch()
        except RuntimeError as e:
            raise DNError('device flush prefetch failed', cause=e)
        if epoch is not None:
            self._pending_flush.append(epoch)

    def _drain_pending(self):
        """Emit the prefetched epochs, oldest first."""
        pending = self._pending_flush
        self._pending_flush = []
        for epoch in pending:
            self._emit_epoch(epoch)

    def note_external_batch(self, n):
        """A batch of n records was processed outside this scanner (the
        multithreaded host executor); counts toward escalation
        thresholds and the observed host rate."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._records_seen += n
        self._host_records += n

    def take_over_now(self):
        """Whether the device path should take over the batch stream
        from the multithreaded host executor (auto mode; see
        datasource_file._takeover_stream)."""
        return (not self._disabled and
                self._records_seen > self._escalate_records() and
                self._engage_device())

    def _escalate_records(self):
        """The record threshold before the device path is considered;
        AutoDeviceScan lowers it when a persisted verdict already
        proved this query shape wins on a device."""
        return self.ESCALATE_RECORDS

    def _engage_device(self):
        """Forced mode: probe the device synchronously on the first
        candidate batch (the caller asked for the device)."""
        if self._backend_ok is None:
            self._probe_backend()
        return self._backend_ok

    def _note_escalated(self):
        if self.route['escalated_at'] is None:
            self.route['escalated_at'] = self._records_seen

    def _probe_ok(self):
        """Device eligibility check (no scan-state mutation), shared by
        the synchronous (forced) and background (auto) probes: one small
        op on the scan's device, its result fetched."""
        from . import faults as mod_faults
        mod_faults.fire('device.probe')
        x = torch.arange(8, dtype=torch.int64, device=self.device)
        ok = int(x.sum()) == 28
        if ok and self.REQUIRE_ACCELERATOR:
            ok = self.device.type == 'cuda'
        return bool(ok)

    def _probe_with_retry(self):
        """_probe_ok with ONE re-probe after a clean refusal (the
        reference resets its backend in between; torch has no such
        reset).  Raised exceptions propagate to the caller."""
        ok = self._probe_ok()
        if not ok:
            self._probe_retries = 1
            ok = self._probe_ok()
        return ok

    def _probe_backend(self):
        """The forced lane's one-time probe, under the probe deadline
        (DN_DEVICE_PROBE_TIMEOUT).  The port keeps its no-silent-CPU
        rule here: a device that fails, refuses or does not answer
        raises a DNError (the reference warns and falls back to its host
        engine).  Returns True."""
        from .errors import DNError
        from .obs import metrics as obs_metrics
        with obs_metrics.timed_stage('device_scan.probe'):
            status, ok = run_with_deadline(self._probe_with_retry,
                                           probe_deadline_s(),
                                           'backend-probe')
        if status == 'ok' and ok:
            self.probe_status = 'ok'
            self._backend_ok = True
            return True
        self.probe_status = status if status != 'ok' else 'refused'
        self._backend_ok = False
        self._disabled = True
        if status == 'timeout':
            raise DNError('device %s unresponsive (no answer within '
                          '%.0fs)' % (self.device, probe_deadline_s()))
        if status == 'error':
            raise DNError('device %s failed its probe' % self.device,
                          cause=DNError(str(ok)))
        raise DNError('device %s refused its probe' % self.device)

    def _sync_device(self):
        """Block until every batch this scan queued has executed,
        without fetching or emitting anything: the timing barrier for
        probation and the audition, and the dispatch backstop.  It waits
        on an event on the scan's own compute stream, never on the whole
        device, so probation, an audition's replay and a live stream on
        other streams never wait on each other's work.  A no-op on the
        CPU, where torch runs eagerly."""
        if self._compute is not None:
            ev = torch.cuda.Event()
            ev.record(self._compute)
            ev.synchronize()

    def _compute_stream(self):
        """The stream this scan's device work runs on: the driving
        thread's current stream when its first batch reaches the device
        (None on the CPU).  K1 launches on the current stream too."""
        if self._compute is None and self.device.type == 'cuda':
            self._compute = torch.cuda.current_stream(self.device)
        return self._compute

    def _note_dispatch(self, token, nbytes):
        """Pipeline bookkeeping for one dispatched batch: count it; when
        the previous batch's token had not completed at dispatch, the
        device was busy while this batch staged and uploaded (an
        overlapped dispatch); then bound the in-flight window by
        blocking on the token from `depth` dispatches back."""
        from .obs import metrics as obs_metrics
        depth = pipeline_depth()
        q = self._pipe
        obs_metrics.inc('device_pipe_dispatches')
        obs_metrics.set_gauge('device_pipeline_depth', depth)
        # on the CPU the tokens are None: overlap cannot be observed
        if q and q[-1] is not None and not q[-1].query():
            obs_metrics.inc('device_pipe_overlapped')
            obs_metrics.inc('device_h2d_overlapped_bytes', int(nbytes))
        q.append(token)
        while len(q) > depth:
            old = q.popleft()
            if old is not None:
                old.synchronize()

    def _after_device_batch(self, n):
        """Count the device batch, then crossover probation: time a
        window of device batches against the host rate observed
        pre-escalation and de-escalate if the device loses.  The window
        is bounded by PROBATION_RECORDS *or* PROBATION_SECONDS,
        whichever trips first."""
        self.route['device_batches'] += 1
        self._note_escalated()
        if not self.PROBATION_RECORDS or self._probation is False:
            return
        now = time.monotonic()
        if self._probation is None:
            # first device batch: pin the host rate, sync its work out,
            # and start the probation clock after it
            if self._host_records and now > self._t0:
                self._host_rate = self._host_records / (now - self._t0)
            self._sync_device()
            self._probation = (time.monotonic(), 0)
            return
        start, seen = self._probation
        seen += n
        if seen < self.PROBATION_RECORDS and \
                now - start < self.PROBATION_SECONDS:
            self._probation = (start, seen)
            return
        self._sync_device()
        elapsed = time.monotonic() - start
        rate = seen / elapsed if elapsed > 0 else float('inf')
        lost = self._host_rate is not None and rate < self._host_rate
        self.route['probation'] = {
            'won': not lost, 'device_rate': _rate_field(rate),
            'host_rate': _rate_field(self._host_rate),
            'window_records': seen, 'window_s': elapsed}
        if lost:
            self._disabled = True
            LOG.info('device de-escalated (lost probation)',
                     device_rate=_rate_field(rate),
                     host_rate=_rate_field(self._host_rate),
                     window_records=seen,
                     window_seconds=round(elapsed, 3))
            # a measured crossover loss is a verdict too: persist it so
            # the next identically-shaped run skips the whole detour
            self._record_crossover(False, rate)
        else:
            LOG.debug('device passed probation',
                      device_rate=_rate_field(rate),
                      host_rate=_rate_field(self._host_rate))
        self._probation = False

    def _record_crossover(self, won, rate):
        """Hook: a probation-window crossover measurement concluded.
        The base scan keeps no persistent state; AutoDeviceScan
        persists the verdict in the audition cache."""

    def route_doc(self):
        """Which engine answered: the route record plus the probe's
        status and whether the device path ended disabled."""
        return dict(self.route, engine=type(self).__name__,
                    probe_status=self.probe_status,
                    escalated=self.route['escalated_at'] is not None,
                    disabled=self._disabled,
                    records_seen=self._records_seen)

    def finish(self):
        sp = self._shadow
        if sp is not None:
            sp.close()          # end of stream: release audition state
            # a replay in flight ends at its next batch; a hung device
            # call is left to its daemon thread (wedge armor)
            sp.join(probe_deadline_s())
            _raise_audition_fault(sp)
        self._flush()
        self._defer_final()
        return self.aggr

    def _emit_counters(self, cvec):
        for (stage, name, always), v in zip(self._counter_spec, cvec):
            v = int(v)
            if always or v:
                stage.bump(name, v)

    def _decode_emit(self, meta, segs, wsum):
        """Decode fused segment codes -> global per-column codes and
        emit."""
        if len(segs) == 0:
            return
        self._emit_cols(meta, _decode_fused(segs, meta['caps']), wsum)

    def _emit_cols(self, meta, col_codes, wsum):
        """Per-column codes -> global codes (window offsets applied)
        -> the shared emit path."""
        if len(wsum) == 0:
            return
        gcols = []
        for (kind, lo), cc in zip(meta['cols'], col_codes):
            if kind == 'str':
                gcols.append(np.asarray(cc, dtype=np.int64))
            else:
                gcols.append(np.asarray(cc, dtype=np.int64) + lo)
        self._emit_unique(gcols, wsum)

    # -- eligibility + input assembly --------------------------------------

    def _try_device(self, provider, weights, alive):
        """Assemble device inputs for this batch; True when submitted.
        Any exactness precondition failure returns False (host path)."""
        if not isinstance(provider, NativeColumns):
            return False
        if self._backend_ok is None:
            self._probe_backend()
        inputs = {}
        staged = self._stage_device(provider, weights, alive, inputs)
        if staged is None:
            return False
        self._run_staged(staged, inputs)
        return True

    def _upload(self, arr):
        """A device-resident table (uploaded once, cached by the
        caller).  On CUDA it crosses from page-locked memory with
        non_blocking=True on the compute stream, so it waits for
        neither the host nor earlier work."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != 'cuda':
            return t.to(self.device)
        self._compute_stream()
        try:
            return t.pin_memory().to(self.device, non_blocking=True)
        except RuntimeError as e:
            raise DNError('device table upload failed', cause=e)

    def _stage_device(self, provider, weights, alive, inputs):
        """Eligibility checks + device-input assembly for one batch,
        writing host arrays into the caller's `inputs` (shared across
        scans under DeviceScanStack: parser-derived columns use
        unprefixed keys so N metric scans upload them once; per-scan
        inputs carry self._pfx).  Returns the staged parameters
        (n, profile, caps, ns, total_w) or None when this batch must
        take the host path.  Commits plan-state (windows/caps) and
        flushes on epoch flips as side effects — safe even if a
        sibling scan later fails staging, since the host path computes
        the same results regardless of plan state."""
        n = provider.n
        pfx = self._pfx

        w = np.asarray(weights, dtype=np.float64)
        if len(w) != n or not np.all(np.isfinite(w)) or \
                not np.all(w == np.floor(w)):
            return None
        total_w = float(np.abs(w).sum())
        if total_w >= 2 ** 31 or (len(w) and
                                  (w.min() < I32MIN or w.max() > I32MAX)):
            return None

        # Upload profile: flags that let the device synthesize constant
        # inputs instead of uploading them (all-ones weights, no alive
        # mask, all-numeric filter fields, all-valid key columns).
        # Flags are STICKY toward the most general variant, so the
        # profile only ever widens across a scan.
        sk = self._sticky
        if sk is None:
            sk = self._sticky = {'w1': True, 'gen_alive': True,
                                 'filter': {}, 'kvalid': {}}
        sk['w1'] = w1 = sk['w1'] and bool(np.all(w == 1.0))
        sk['gen_alive'] = gen_alive = sk['gen_alive'] and alive is None
        if not gen_alive:
            inputs['alive'] = np.ones(n, dtype=bool) if alive is None \
                else np.asarray(alive, dtype=bool)
        if not w1:
            inputs['weights'] = w.astype(np.int32)

        # one-pass native batch statistics make the eligibility checks
        # O(1) numpy work per field (providers without them take the
        # numpy path)
        src = provider.parser

        # per-batch memo on the SHARED provider: each parser accessor
        # materializes a fresh array (ctypes copy); a field read twice
        # (or by several stacked metrics) pays that once
        memo = provider.__dict__.setdefault('_stage_memo', {})

        def _memo1(kind, f, fn):
            key = (kind, f)
            v = memo.get(key)
            if v is None:
                v = fn(f)
                memo[key] = v
            return v

        def _stats(f):
            fn = getattr(src, 'field_stats', None)
            return _memo1('stats', f, fn) if fn is not None else None

        def _widen(table, key, has_str, has_num, all_num):
            cur = table.get(key)
            if cur is None:
                cur = table[key] = [has_str, has_num, all_num]
            else:
                cur[0] = cur[0] or has_str
                cur[1] = cur[1] or has_num
                cur[2] = cur[2] and all_num
            return cur

        # dtype narrowing: per-record int columns upload as the
        # smallest dtype their observed range fits, widened stickily;
        # the device upcasts after the transfer
        dtypes = sk.setdefault('dtypes', {})

        def _narrow(key, arr, lo, hi):
            if 0 <= lo and hi <= 255:
                need = 1
            elif I16MIN <= lo and hi <= I16MAX:
                need = 2
            else:
                need = 3
            level = max(dtypes.get(key, need), need)
            dtypes[key] = level
            if level == 1:
                return arr.astype(np.uint8)
            if level == 2:
                return arr.astype(np.int16)
            return arr if arr.dtype == np.int32 \
                else arr.astype(np.int32)

        # filter fields: tags + string codes + exact-i32 numeric
        # values, each uploaded only when this scan has seen rows of
        # that kind in the field
        filter_profile = []
        for f in self.filter_fields:
            st = _stats(f)
            if st is not None:
                narr, i32ok, nmn_f, nmx_f, nnum, nstr = st
                if narr:
                    return None
                if nnum and not i32ok:
                    return None
                has_str, has_num, all_num = _widen(
                    sk['filter'], f, nstr > 0, nnum > 0, nnum == n)
                tags = _memo1('tags', f, src.tags_col) \
                    if not all_num else None
                strcodes = _memo1('str', f, src.strcodes_col) \
                    if has_str else None
                iv = _memo1('num', f, src.nums_i32) if has_num else None
                nrange = (int(nmn_f), int(nmx_f)) if nnum else (0, 0)
            else:
                tags, nums, strcodes = provider._field(f)
                if (tags == mn.TAG_ARRAY).any():
                    return None
                m = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
                obs_num = bool(m.any())
                if obs_num:
                    nm = nums[m]
                    if not (np.all(np.isfinite(nm)) and
                            np.all(nm == np.floor(nm)) and
                            nm.min() >= I32MIN and nm.max() <= I32MAX):
                        return None
                has_str, has_num, all_num = _widen(
                    sk['filter'], f, bool((tags == mn.TAG_STRING)
                                          .any()), obs_num,
                    bool(m.all()))
                iv = None
                nrange = (0, 0)
                if has_num:
                    iv = np.zeros(n, dtype=np.int32)
                    if obs_num:
                        iv[m] = nums[m].astype(np.int64).astype(
                            np.int32)
                        nrange = (int(nums[m].min()),
                                  int(nums[m].max()))
            filter_profile.append((f, has_str, has_num, all_num))
            if not all_num:
                inputs['tags_' + f] = tags.astype(np.uint8, copy=False)
            if has_str and ('str_' + f) not in inputs:
                # -1 marks non-string rows (masked on device), so the
                # floor of the range is -1
                dlen = len(src.dictionary(f))
                inputs['str_' + f] = _narrow('str_' + f, strcodes,
                                             -1, dlen - 1)
            if has_num and ('num_' + f) not in inputs:
                inputs['num_' + f] = _narrow('num_' + f, iv, *nrange)

        # synthetic date fields: combined first-error + needed ts columns
        synth_vals = {}
        use_dstats = False
        if self.synthetic:
            dstats_fn = getattr(src, 'date_stats', None)
            first_ds = _memo1('dstats', self.synthetic[0]['field'],
                              dstats_fn) \
                if dstats_fn is not None else None
            use_dstats = first_ds is not None
            errs = None
            if use_dstats:
                # SHARED keys: under dstats the ts column is a pure
                # function of its source field ('tsf_<field>') and the
                # error chain of the ordered field list, so stacked
                # sibling scans reading the same date fields reuse one
                # upload
                terr_key = 'terr_' + '|'.join(
                    fc['field'] for fc in self.synthetic)
                for i, fc in enumerate(self.synthetic):
                    all_i32, nok = first_ds if i == 0 \
                        else _memo1('dstats', fc['field'], dstats_fn)
                    if nok and not all_i32:
                        return None
                    synth_vals[fc['name']] = _memo1(
                        'date', fc['field'], src.date_i32)
                errs = inputs.get(terr_key)
                if errs is None:
                    for fc in self.synthetic:
                        err = _memo1('derr', fc['field'], src.date_err)
                        errs = err if errs is None else \
                            np.where(errs == 0, err, errs)
            else:
                terr_key = pfx + 'terr'
                for fc in self.synthetic:
                    vals, err = provider.date_column(fc['field'])
                    synth_vals[fc['name']] = vals
                    errs = err if errs is None else \
                        np.where(errs == 0, err, errs)
            ok = errs == 0
            sfield = {s['name']: s['field'] for s in self.synthetic}
            need = set()
            if self.time_bounds is not None:
                need.add('dn_ts')
            for p in self._plans:
                if p.field.startswith('\0synth:'):
                    need.add(p.field[len('\0synth:'):])
            for name in need:
                v = synth_vals[name]
                if use_dstats:
                    # already exact-i32 with error rows zeroed
                    inputs['tsf_' + sfield[name]] = v
                    continue
                vo = v[ok]
                if len(vo) and not (np.all(np.isfinite(vo)) and
                                    np.all(vo == np.floor(vo)) and
                                    vo.min() >= I32MIN and
                                    vo.max() <= I32MAX):
                    return None
                inputs[pfx + 'ts_' + name] = np.where(ok, v, 0).astype(
                    np.int64).astype(np.int32)
            inputs[terr_key] = errs

        # key columns: update windows/caps, assemble uploads
        new_caps = []
        pending = []  # deferred plan-state commits
        kvalid_profile = []   # plan names whose kvalid upload is skipped
        for p in self._plans:
            if p.kind == 'str':
                st = _stats(p.name)
                if st is not None:
                    all_str = st[5] == n
                    strcodes = None    # fetched only if needed below
                else:
                    tags, _, strcodes = provider._field(p.name)
                    all_str = bool((tags == mn.TAG_STRING).all())
                host = p.host_translate or not all_str
                if host:
                    codes = np.asarray(
                        provider.string_codes(p.name, p.column),
                        dtype=np.int64)
                    radix_now = len(p.column.dict.values)
                    inputs[pfx + 'key_' + p.name] = _narrow(
                        'key_' + p.name, codes, 0,
                        max(radix_now - 1, 0))
                else:
                    trans = _native_str_trans(
                        p.column, provider.parser.dictionary(p.name))
                    cur = self._trans_dev.get(p.name)
                    if cur is None or cur[0] < len(trans):
                        self._trans_dev[p.name] = (
                            len(trans), self._upload(
                                trans.astype(np.int32)))
                    inputs[pfx + 'trans_' + p.name] = \
                        self._trans_dev[p.name][1]
                    if ('str_' + p.name) not in inputs:
                        # (a field that is both filter and breakdown
                        # reuses the filter loop's upload)
                        if strcodes is None:
                            strcodes = _memo1('str', p.name,
                                              src.strcodes_col)
                        dlen = len(provider.parser.dictionary(p.name))
                        inputs['str_' + p.name] = _narrow(
                            'str_' + p.name, strcodes, 0,
                            max(dlen - 1, 0))
                radix = len(p.column.dict.values)
                cap = max(p.cap, _pow2(max(radix, 1)))
                new_caps.append(cap)
                pending.append((p, cap, p.lo, host, True))
            else:
                if p.field.startswith('\0synth:'):
                    sname = p.field[len('\0synth:'):]
                    # window from real (err-free) timestamps only: the
                    # zero-filled error rows are dead and must not
                    # anchor the window at ordinal 0
                    sel = synth_vals[sname][ok]
                    minmax = (int(sel.min()), int(sel.max())) \
                        if len(sel) else None
                else:
                    st = _stats(p.name)
                    if st is not None and st[0] == 0 and st[5] == 0:
                        # no strings/arrays: the numeric rows ARE the
                        # valid rows, and min/max come from the stats
                        narr, i32ok, nmn, nmx, nnum, _ = st
                        if nnum and not i32ok:
                            return None
                        if ('kv_' + p.name) not in inputs:
                            inputs['kv_' + p.name] = _narrow(
                                'kv_' + p.name,
                                _memo1('num', p.name, src.nums_i32),
                                int(nmn) if nnum else 0,
                                int(nmx) if nnum else 0)
                        kv_skip = sk['kvalid'].get(p.name, True) and \
                            nnum == n
                        sk['kvalid'][p.name] = kv_skip
                        if kv_skip:
                            # every row numeric: no validity upload
                            kvalid_profile.append(p.name)
                        elif ('kvalid_' + p.name) not in inputs:
                            tags_k = _memo1('tags', p.name,
                                            src.tags_col)
                            inputs['kvalid_' + p.name] = \
                                (tags_k == mn.TAG_INT) | \
                                (tags_k == mn.TAG_NUMBER)
                        minmax = (int(nmn), int(nmx)) if nnum else None
                    else:
                        vals, valid = provider.numeric_column(p.name)
                        vv = vals[valid]
                        if len(vv) and not (np.all(np.isfinite(vv)) and
                                            np.all(vv == np.floor(vv))
                                            and vv.min() >= I32MIN and
                                            vv.max() <= I32MAX):
                            return None
                        if ('kv_' + p.name) not in inputs:
                            fill = int(vv[0]) if len(vv) else 0
                            v = np.where(valid, vals,
                                         fill).astype(np.int64)
                            inputs['kv_' + p.name] = _narrow(
                                'kv_' + p.name, v.astype(np.int32),
                                int(vv.min()) if len(vv) else 0,
                                int(vv.max()) if len(vv) else 0)
                        kv_skip = sk['kvalid'].get(p.name, True) and \
                            bool(valid.all())
                        sk['kvalid'][p.name] = kv_skip
                        if kv_skip:
                            kvalid_profile.append(p.name)
                        elif ('kvalid_' + p.name) not in inputs:
                            inputs['kvalid_' + p.name] = valid
                        minmax = (int(vv.min()), int(vv.max())) \
                            if len(vv) else None
                if p.kind == 'p2':
                    new_caps.append(p.cap)  # fixed [0, 32)
                    pending.append((p, p.cap, 0, False, True))
                    continue
                if minmax is not None:
                    omin = int(np.floor_divide(minmax[0], p.step))
                    omax = int(np.floor_divide(minmax[1], p.step))
                    if p.window_set:
                        lo = min(p.lo, omin)
                        hi = max(p.lo + p.cap - 1, omax)
                    else:
                        lo, hi = omin, omax
                    cap = max(p.cap, _pow2(hi - lo + 1))
                    new_caps.append(cap)
                    pending.append((p, cap, lo, False, True))
                else:
                    new_caps.append(p.cap)
                    pending.append((p, p.cap, p.lo, False,
                                    p.window_set))

        ns = 1
        for c in new_caps:
            ns *= c
        sparse = False
        if ns > MAX_DENSE_SEGMENTS:
            # high-cardinality: no dense accumulator fits, so run the
            # SPARSE program (fused i64 keys sort-merged into a
            # device-resident compacted set).  Excluded under a mesh (a
            # sparse set has no sum/min merge).  Per-column codes are
            # i32 on device, so a fused key beyond 2^62 or a cap beyond
            # 2^31 can never run there: host path instead.
            if self._device_mesh() is not None or ns > (1 << 62) or \
                    max(new_caps) > (1 << 31):
                self._disabled = True
                return None
            sparse = True

        # commit plan-state changes; an epoch flip flushes
        for p, cap, lo, host, wset in pending:
            p.cap, p.lo, p.host_translate = cap, lo, host
            p.window_set = wset
        sig = tuple(p.sig() for p in self._plans)
        if sig != self._epoch_sig:
            self._flush()
            self._epoch_sig = sig

        # the overflow guard runs AFTER any epoch-flip flush (a flush
        # resets the unique-count bound, which must then re-reserve
        # THIS batch or the bound undercounts by a batch)
        if sparse and not self._sparse_guard(n):
            return None

        # leaf outcome tables (grown host-side, resident on device);
        # the outcome by tag of the other rows is in the scan program
        for i, (key, leaf) in enumerate(self._leaf_list):
            d = provider.parser.dictionary(leaf.field)
            table = leaf.table_for(d)
            cur = self._leaf_tables.get(i)
            if cur is None or cur[0] < len(table):
                up = table if len(table) else np.zeros(1, dtype=np.int8)
                self._leaf_tables[i] = (len(table), self._upload(up))
            inputs[pfx + 'tab_%d' % i] = self._leaf_tables[i][1]

        # under a mesh, pad the per-record arrays with dead rows to a
        # multiple of the shard count, so every shard gets an equal
        # slice (the single-device path copies only the batch's rows)
        mesh_info = self._device_mesh()
        if mesh_info is not None:
            pad = (-n) % mesh_info[0].size
            if pad:
                for k, v in list(inputs.items()):
                    if isinstance(v, np.ndarray) and v.ndim == 1 and \
                            len(v) == n:
                        inputs[k] = np.concatenate(
                            [v, np.zeros(pad, dtype=v.dtype)])

        profile = (w1, gen_alive,
                   {f: (hs, hn, an) for f, hs, hn, an in filter_profile},
                   frozenset(kvalid_profile), use_dstats,
                   self._sparse_cap if sparse else 0)
        return (n, profile, tuple(new_caps), ns, total_w)

    def _sparse_guard(self, n):
        """Prevent resident-set overflow BEFORE folding a batch: track
        an upper bound on uniques (exact count at last check + records
        since); when this batch could overflow, sync-fetch the true
        count from the accumulator, and if still at risk flush the
        (correct-so-far) epoch and grow the capacity.  Returns False
        when the scan must take the host path instead (capacity
        ceiling: device permanently disabled for this scan)."""
        while True:
            cap = self._sparse_cap
            if self._sparse_ub + n <= cap:
                self._sparse_ub += n
                return True
            if self._acc is not None and len(self._acc) == 5:
                nuniq = int(self._acc[4][0])
                if nuniq + n <= cap:
                    self._sparse_ub = nuniq + n
                    return True
            self._flush()
            if cap >= SPARSE_CAP_MAX:
                self._disabled = True
                self.aggr.stage.bump_hidden('nsparseceiling', 1)
                LOG.info('sparse set capacity ceiling reached; '
                         'host path takes over', cap=cap)
                return False
            self._sparse_cap = cap * 4
            self.aggr.stage.bump_hidden('nsparsegrow', 1)
            LOG.debug('sparse set grown', cap=self._sparse_cap)

    def _ensure_acc(self, caps, ns, sparse_cap=0):
        if self._acc is None:
            dev = self.device
            ncnt = len(self._counter_spec)
            i64 = torch.int64
            if sparse_cap:
                self._acc = (
                    torch.full((sparse_cap,), I64MAX, dtype=i64,
                               device=dev),
                    torch.zeros(sparse_cap, dtype=i64, device=dev),
                    torch.full((sparse_cap,), I64MAX, dtype=i64,
                               device=dev),
                    torch.zeros(ncnt, dtype=i64, device=dev),
                    torch.zeros(2, dtype=i64, device=dev))
            else:
                acc_ns = max(ns, 1)
                self._acc = (
                    torch.zeros(acc_ns, dtype=i64, device=dev),
                    torch.full((acc_ns,), I64MAX, dtype=i64, device=dev),
                    torch.zeros(ncnt, dtype=i64, device=dev))
            self._acc_meta = {
                'caps': tuple(caps),
                'cols': [(p.kind, p.lo) for p in self._plans],
                'ns': max(ns, 1),
                'sparse_cap': sparse_cap,
            }
            self._acc_batch = 0

    def _upload_inputs(self, inputs):
        """This batch's per-record inputs through the scan's staging
        ring (device-resident tables pass through): (args, nbytes,
        slot)."""
        ring = self._ring
        if ring is None:
            ring = self._ring = _StagingRing(self.device,
                                             pipeline_depth() + 1)
        return ring.stage(inputs, mod_engine.BATCH_SIZE,
                          self._compute_stream())

    def _run_staged(self, staged, inputs):
        if self._device_mesh() is not None:
            # the per-record inputs, which a mesh splits across its
            # shards (every other input is a table each shard reads
            # whole)
            self._mesh_rows = frozenset(k for k, v in inputs.items()
                                        if isinstance(v, np.ndarray))
        if self.capture_next:
            # before the upload: the benchmark tells the per-record
            # host arrays (its H2D) from the resident tables by type
            self.capture_next = False
            self.captured = (dict(inputs), staged, uses_kernel(staged))
        args, nbytes, slot = self._upload_inputs(inputs)
        self._fold_staged(staged, args)
        _note_h2d(nbytes)
        self._note_dispatch(self._ring.release(slot, self._compute),
                            nbytes)
        if self._acc_batch % SYNC_EVERY_BATCHES == 0:
            self._sync_device()

    def _fold_staged(self, staged, args):
        """Fold one staged batch (inputs already on the device) into
        this scan's resident accumulator: the sparse fold, or the dense
        body through the one-hot kernel or index_add_, on one device or
        sharded across the mesh."""
        n, profile, caps, ns, total_w = staged
        sparse_cap = profile[-1]
        self._compute_stream()
        self._ensure_acc(caps, ns, sparse_cap=sparse_cap)
        base = self._acc_batch << 32
        if sparse_cap:
            # the guard reserved this batch in the bound already; the
            # set's occupied prefix is at most the bound before it
            self._fold_sparse(args, n, profile, caps,
                              min(sparse_cap, self._sparse_ub - n), base)
        else:
            use_kernel = uses_kernel(staged)
            mesh_info = self._device_mesh()
            if mesh_info is None:
                self._fold(args, n, profile, caps, ns, use_kernel, base)
            else:
                self._fold_mesh(mesh_info[0], args, self._mesh_rows, n,
                                profile, caps, ns, use_kernel, base)
        self._acc_batch += 1

    # -- the device program (K2, scan_program.py) --------------------------

    def _program(self, profile, caps, ns, mode):
        """The compiled scan program for a batch staged with `profile`
        and `caps` in output `mode`, memoised per plan signature (the
        key windows), upload profile, caps and mode; an epoch flip
        leaves the old programs unused, so the memo is dropped when it
        grows past a few epochs' worth."""
        w1, gen_alive, fprof, kvalid, use_dstats, _ = profile
        key = (self._epoch_sig, mode, tuple(caps), ns, w1, gen_alive,
               tuple(sorted(fprof.items())), kvalid, use_dstats)
        prog = self._programs.get(key)
        if prog is None:
            if len(self._programs) >= 64:
                self._programs.clear()
            prog = self._programs[key] = scan_program.compile_program(
                self, profile, caps, ns, mode)
        return prog

    def _key_buf(self, dev, n):
        """K2's i32 fused-key output for K1, reused batch after batch on
        `dev` (both run on its current stream, in order)."""
        buf = self._key_bufs.get(dev)
        if buf is None or buf.shape[0] < n:
            buf = self._key_bufs[dev] = torch.empty(
                _pow2(max(n, mod_engine.BATCH_SIZE)), dtype=torch.int32,
                device=dev)
        return buf

    def _run_body(self, args, n, profile, caps, ns, use_kernel, dense,
                  first, cvec, base, row0=0, nvalid=None):
        """One batch's program into (dense i64[ns], first i64[ns], cvec
        i64[ncounters]), all added into: K2 alone (the weights added by
        the program), or on the kernel route K2's fused key and K1.  A
        mesh shard runs it on its `n` rows of the padded batch: `row0`
        makes its row indices global (so the cross-shard min is the
        batch's first occurrence) and rows from `nvalid` on are padding
        (dead when alive is synthesized)."""
        if not use_kernel:
            prog = self._program(profile, caps, ns, scan_program.MODE_DENSE)
            scan_program.scan_body(prog, args, n, dense, first, cvec, base,
                                   row0, nvalid)
            return
        prog = self._program(profile, caps, ns, scan_program.MODE_K1)
        key = scan_program.scan_body(
            prog, args, n, None, first, cvec, base, row0, nvalid,
            key_out=self._key_buf(cvec.device, n))
        # dead rows sit at ns, outside the accumulator
        cuda_kernels.onehot_dense_into(
            dense, key, None if profile[0] else args['weights'])

    def _fold(self, args, n, profile, caps, ns, use_kernel, base):
        """One batch folded into the device-resident accumulator, in
        place: dense weights and counters add; the first-occurrence key
        takes a running min over (batch_base | row), which orders keys
        exactly as the host engine inserts them."""
        dense, first, cvec = self._acc
        self._run_body(args, n, profile, caps, ns, use_kernel, dense,
                       first, cvec, base)

    def _fold_mesh(self, mesh, args, rows, n, profile, caps, ns,
                   use_kernel, base):
        """_fold for a batch run sharded across the mesh (_mesh_body)."""
        dense, first, cvec = self._mesh_body(mesh, args, rows, n, profile,
                                             caps, ns, use_kernel)
        self._accumulate(dense, first, cvec, base)

    def _accumulate(self, dense, first, cvec, base):
        """Fold merged mesh partials (first: global rows, I64MAX where a
        segment did not occur) into the resident accumulator."""
        acc_dense, acc_first, acc_cvec = self._acc
        bfirst = torch.where(first < I64MAX, first + base, I64MAX)
        acc_dense += dense
        torch.minimum(acc_first, bfirst, out=acc_first)
        acc_cvec += cvec

    def _mesh_body(self, mesh, args, rows, n, profile, caps, ns,
                   use_kernel):
        """One batch across the mesh (K9): shard s runs the program on
        rows [s*bn, (s+1)*bn) of the padded batch on its device, with
        global row indices, into zeroed partials of its own (K2, and on
        the kernel route K1).  The partials merge on the accumulator's
        device (mesh.merge_partials: dense and counters by sum, first
        by min)."""
        from .parallel import mesh as mod_mesh
        bn = -(-n // mesh.size)
        ncnt = len(self._counter_spec)
        i64 = torch.int64
        parts = []
        for s, dev in enumerate(mesh.devices):
            sargs = {}
            for k, v in args.items():
                if k in rows:
                    v = v[s * bn:(s + 1) * bn]
                sargs[k] = v.to(dev)
            part = (torch.zeros(ns, dtype=i64, device=dev),
                    torch.full((ns,), I64MAX, dtype=i64, device=dev),
                    torch.zeros(ncnt, dtype=i64, device=dev))
            self._run_body(sargs, bn, profile, caps, ns, use_kernel,
                           *part, base=0, row0=s * bn, nvalid=n)
            parts.append(part)
        return mod_mesh.merge_partials(parts, self.device)

    def _fold_sparse(self, args, n, profile, caps, occupied, base):
        """One batch sort-merged into the resident sparse set: K2 adds
        the counters and gives the rows' fused keys, weights (1 or the
        row's weight) and first occurrences (batch_base | row); see
        fold_sparse."""
        prog = self._program(profile, caps, 0, scan_program.MODE_SPARSE)
        fused, wb, first_b = scan_program.scan_body(
            prog, args, n, None, None, self._acc[3], base)
        self._acc = fold_sparse(self._acc, None, fused, wb, first_b,
                                occupied)

    # -- mesh hooks (no-ops on the single-device path; the cluster
    # backend's MeshDeviceScan overrides them) ----------------------------

    def _device_mesh(self):
        """(Mesh, axis_name) to shard the per-record axis over, or None
        for single-device execution."""
        return None

    def _mesh_key(self):
        m = self._device_mesh()
        if m is None:
            return None
        return m[0].key()

    # -- flush: fetch + ordered merge ---------------------------------------

    def _flush(self):
        """Fetch the device accumulator and merge it into the
        insertion-ordered Aggregator.  Prefetched epochs drain first, so
        emission order is the host engine's."""
        self._drain_pending()
        epoch = self._take_epoch()
        if epoch is not None:
            self._emit_epoch(epoch)

    def _take_epoch(self):
        """Detach the epoch's accumulator and issue its one fetch (the
        copies start together, into page-locked memory on the card):
        a sparse set or a dense accumulator of COMPACT_MIN_SEGMENTS or
        more is compacted on the device first, at a speculative width.
        Returns what _emit_epoch takes, or None when nothing
        accumulated.  The accumulator stays referenced: a width that
        turns out too small refetches from it."""
        acc = self._acc
        if acc is None:
            return None
        meta = self._acc_meta
        nbatches = self._acc_batch
        sparse_ub = self._sparse_ub
        self._acc = None
        self._acc_meta = None
        self._acc_batch = 0
        self._sparse_ub = 0
        self._pipe.clear()      # the fetch waits for the epoch's folds
        acc_len = int(acc[0].shape[0])
        if meta['sparse_cap']:
            kind = 'sparse'
            k = _pow2(max(min(sparse_ub, meta['sparse_cap']), 1)) \
                if sparse_ub else self.COMPACT_K
            cols, w32, wof, cvec, stats = _sparse_program(
                acc, min(acc_len, k), meta['caps'])
            out = list(cols) + [w32, wof, cvec, stats]
        elif not meta['cols']:
            kind, out = 'total', [acc[0], acc[2]]
        elif meta['ns'] >= self.COMPACT_MIN_SEGMENTS:
            kind = 'compact'
            out = list(_compact_program(acc, min(acc_len,
                                                 self.COMPACT_K)))
        else:
            kind, out = 'dense', list(acc)
        return kind, meta, nbatches, acc, _issue_async(out)

    def _emit_epoch(self, epoch):
        """Wait on an epoch's fetch and emit it: refetch wider from the
        kept accumulator where more segments occurred than the
        speculative width (or a sparse weight sum passed i32), then
        decode and emit counters and keys."""
        kind, meta, nbatches, acc, fetched = epoch
        # engine telemetry: batches folded on the device this epoch
        # (kept out of the --counters dump for golden byte parity)
        if nbatches:
            self.aggr.stage.bump_hidden('ndevicebatches', nbatches)
        got = _wait_fetched(*fetched)
        if kind == 'total':
            dense, cvec = got
            self._emit_counters(cvec)
            self.aggr.write_key((), self._weight(int(dense[0])))
            return
        if kind == 'dense':
            segs, wsum, cvec = _dense_order(*got)
        elif kind == 'compact':
            self.aggr.stage.bump_hidden('ncompactflush', 1)
            cnt, segs, dense, cvec = got
            n = int(cnt)
            if n > len(segs):
                segs, wsum, cvec = _compact_fetch(acc, n)
            else:
                segs = segs[:n].astype(np.int64)
                wsum = dense[:n].astype(np.float64)
        else:
            self.aggr.stage.bump_hidden('ncompactflush', 1)
            cols = got[:-4]
            w32, wof, cvec, st = got[-4:]
            n = int(st[0])
            if n > len(cols[0]) or bool(wof):
                cols, wsum, cvec, st = _sparse_fetch(acc, n, meta['caps'])
            else:
                cols = [c[:n].astype(np.int64) for c in cols]
                wsum = w32[:n].astype(np.float64)
            if int(st[1]):
                # the host pressure guard exists to make this
                # unreachable; if it ever trips, results are
                # incomplete: fail loudly
                raise RuntimeError(
                    'device sparse aggregation overflowed its resident '
                    'set (cap=%d); results would be incomplete'
                    % meta['sparse_cap'])
            self._emit_counters(cvec)
            self._emit_cols(meta, cols, wsum)
            return
        self._emit_counters(cvec)
        # global codes for the shared emit path: device string codes
        # are already engine-dictionary codes; bucket codes offset
        # by the window origin give raw ordinals
        self._decode_emit(meta, segs, wsum)


def fold_sparse(acc, cvec, fused, wb, first_b, occupied=None):
    """Sparse fold: sort-merge one batch's fused i64 keys (dead rows at
    I64MAX), i64 weights and first-occurrence keys into the resident
    compacted set `acc` = (keys, wsum, first, cvec, stats), in place,
    and returns it.  keys/first take the per-key min
    (first-occurrence order preserved exactly), weights sum, and the
    unique count rides along in stats[0] so the host pressure guard
    can read it without a full fetch; stats[1] is the sticky overflow
    flag.

    The set keeps its occupied slots sorted by key in a prefix, with
    I64MAX / 0 / I64MAX past it, so only `occupied` (an upper bound on
    the prefix; default the whole set) plus the batch are sorted and
    rewritten.  Run ids past the capacity land in one extra slot of a
    cap + 1 buffer that is sliced off (torch's scatters would raise on
    them); the overflow flag makes that loud at flush.  `cvec` is added
    into the set's counters, or None where the caller's program added
    them already (DeviceScan's K2)."""
    sparse_folds['fold_sparse'] += 1
    keys0, wsum0, first0, cvec0, stats0 = acc
    cap = int(keys0.shape[0])
    occ = cap if occupied is None else max(0, min(int(occupied), cap))
    i64 = torch.int64
    k = torch.cat([keys0[:occ], fused])
    order = torch.argsort(k)
    ks = k[order]
    ws = torch.cat([wsum0[:occ], wb])[order]
    fs = torch.cat([first0[:occ], first_b])[order]
    newrun = torch.ones_like(ks, dtype=torch.bool)
    newrun[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(newrun, 0, dtype=i64) - 1
    nuniq = (newrun & (ks != I64MAX)).sum(dtype=i64)
    # the rewritten prefix: every unique of the merge fits in it when
    # the guard's bound holds (slots past it are untouched sentinels)
    m = min(cap, int(k.shape[0]))
    seg = torch.clamp_max(seg, m)
    dev = ks.device
    keys1 = torch.full((m + 1,), I64MAX, dtype=i64, device=dev)
    keys1.scatter_reduce_(0, seg, ks, 'amin', include_self=True)
    wsum1 = torch.zeros(m + 1, dtype=i64, device=dev)
    wsum1.index_add_(0, seg, ws)
    first1 = torch.full((m + 1,), I64MAX, dtype=i64, device=dev)
    first1.scatter_reduce_(0, seg, fs, 'amin', include_self=True)
    # the accumulator is updated in place (the reference donates it to
    # its jitted fold); the merge's temporaries come from the caching
    # allocator, since their sizes change with every batch
    keys0[:m] = keys1[:m]
    wsum0[:m] = wsum1[:m]
    first0[:m] = first1[:m]
    if cvec is not None:
        cvec0 += cvec.to(i64)
    stats0[1] = torch.maximum(stats0[1], (nuniq > cap).to(i64))
    stats0[0] = nuniq
    return acc


def _compact_program(acc, k):
    """Device-side compaction of a dense accumulator: (count of
    occurred segments, their ids in first-occurrence order (first k,
    -1 past the count), their weights, counters)."""
    dense, first, cvec = acc
    cnt = (first < I64MAX).sum()
    # ascending argsort puts occurred segments first, in exact
    # first-occurrence order (firsts are distinct: each global row
    # index belongs to one segment); I64MAX sentinels sort last
    order = torch.argsort(first, stable=True)[:k]
    occ = first[order] < I64MAX
    segs = torch.where(occ, order, -1)
    return cnt, segs, dense[order], cvec


def _compact_fetch(acc, n):
    """Refetch of a compacted dense epoch whose `n` occurred segments
    passed the speculative width: (segs i64[n] in first-occurrence
    order, weights f64[n], cvec)."""
    _, segs, dense, cvec = _fetch(_compact_program(acc, n))
    return segs.copy(), dense.astype(np.float64), cvec


def _dense_order(dense, first, cvec):
    """A fetched dense accumulator's occurred segments in
    first-occurrence order: (segs, weights f64, cvec)."""
    occurred = np.nonzero(first < I64MAX)[0]
    order = np.argsort(first[occurred], kind='stable')
    segs = occurred[order]
    return segs, dense[segs].astype(np.float64), cvec


def _narrow_dtype(cap):
    if cap <= 256:
        return torch.uint8
    if cap <= 32768:
        return torch.int16
    return torch.int32


def _sparse_program(acc, k, caps):
    """Compacting fetch of the sparse set: occupied slots ordered by
    first occurrence, with the fused keys DECODED to per-column codes on
    device and every output dtype-narrowed (the fewest bytes that
    represent the result), plus a flag that triggers the full-precision
    refetch for weight sums beyond i32."""
    keys, wsum, first, cvec, stats = acc
    order = torch.argsort(first, stable=True)[:k]
    ks = keys[order]
    cols = []
    div = 1
    for cap_i in reversed(caps):
        c = torch.remainder(torch.div(ks, div, rounding_mode='floor'),
                            cap_i)
        cols.append(c.to(_narrow_dtype(cap_i)))
        div *= cap_i
    cols.reverse()
    ws = wsum[order]
    wof = ((ws > I32MAX) | (ws < I32MIN)).any()
    return cols, ws.to(torch.int32), wof, cvec, stats


def _sparse_program_full(acc, k):
    """Full-precision fetch (i64 keys + weights): used when a weight
    sum overflows i32 (the wof flag)."""
    keys, wsum, first, cvec, stats = acc
    order = torch.argsort(first, stable=True)[:k]
    return keys[order], wsum[order], cvec, stats


def _sparse_fetch(acc, n, caps):
    """Refetch of a sparse epoch whose `n` uniques passed the speculative
    width, or whose weight sums passed i32: its occupied slots in exact
    first-occurrence order, (per-column code arrays i64, weights f64,
    cvec, stats).  More uniques than the set holds is an overflow: what
    exists is fetched, and the caller's stats[1] check raises."""
    n = max(1, min(n, int(acc[0].shape[0])))
    cols, w32, wof, cvec, stats = _sparse_program(acc, n, tuple(caps))
    got = _fetch(list(cols) + [w32, wof, cvec, stats])
    cols, (w32, wof, cvec, st) = got[:-4], got[-4:]
    n = min(n, int(st[0]))
    if bool(wof):
        keys, wsum, cvec, _ = _fetch(_sparse_program_full(acc, n))
        return (_decode_fused(keys, caps), wsum.astype(np.float64),
                cvec, st)
    return ([c[:n].astype(np.int64) for c in cols],
            w32[:n].astype(np.float64), cvec, st)


def _decode_fused(keys, caps):
    """Host-side fused-key decode."""
    rem = keys.copy()
    cols = [None] * len(caps)
    for ci in range(len(caps) - 1, -1, -1):
        cols[ci] = rem % caps[ci]
        rem = rem // caps[ci]
    return cols


class DeviceScanStack(object):
    """One staged input dict per batch for an N-metric build.

    Every scan stages its inputs into ONE merged dict (parser-derived
    columns use shared keys, so a column read by several metrics is
    uploaded once; per-scan inputs carry an 'm<i>_' prefix), then each
    scan folds the batch into its own device-resident accumulator —
    dense (K2 alone, or K2 and the one-hot kernel) or sparse.  Scans
    keep their own accumulators, flush and emission, so per-scan results
    (and the index artifacts) are byte-identical to the unstacked path.

    The reference jits the N folds into one combined program, caches it
    across builds (_STACK_CACHE) and memoizes the program keys
    (_pkey_memo); the port launches one scan program per metric a batch
    (K2, and K1 on its route), each memoised by its scan (_program)."""

    def __init__(self, scans):
        self.scans = list(scans)
        self._nbatch = 0
        # shared sticky upload-profile state: widening decisions apply
        # to the shared physical inputs, so all scans must agree
        shared = {'w1': True, 'gen_alive': True, 'filter': {},
                  'kvalid': {}, 'dtypes': {}}
        for i, s in enumerate(self.scans):
            assert s.STACKABLE
            s._pfx = 'm%d_' % i
            s._sticky = shared

    def process(self, provider, weights, alive):
        """Process one batch for every scan: the stacked device fold
        when every scan stages successfully, else the per-scan paths
        (each of which may still use its own device fold or the host
        engine).  Exactly one of these runs per batch, so insertion
        order and results match the unstacked path."""
        n = provider.n
        for s in self.scans:
            if s._t0 is None:
                s._t0 = time.monotonic()
        if self._device_eligible(provider, n) and \
                self._process_device(provider, weights, alive):
            for s in self.scans:
                s._records_seen += n
                s._after_device_batch(n)
            return
        for s in self.scans:
            s._process(provider, weights, alive=alive)

    def _device_eligible(self, provider, n):
        if not isinstance(provider, NativeColumns):
            return False
        for s in self.scans:
            # mirror DeviceScan._process's escalation compare, which
            # tests records_seen AFTER counting this batch
            s._records_seen += n
            try:
                ok = (not s._disabled and
                      s._records_seen > s._escalate_records() and
                      s._engage_device())
            finally:
                s._records_seen -= n
            if not ok:
                return False
        return True

    def _process_device(self, provider, weights, alive):
        """One staged upload for the N metrics (through the first
        scan's staging ring), N folds, one completion token for the
        whole stacked batch."""
        inputs = {}
        staged = []
        for s in self.scans:
            st = s._stage_device(provider, weights, alive, inputs)
            if st is None:
                return False
            staged.append(st)
        lead = self.scans[0]
        args, nbytes, slot = lead._upload_inputs(inputs)
        for s, st in zip(self.scans, staged):
            s._fold_staged(st, args)
            # telemetry: this batch went through the stacked fold
            # (kept out of --counters for golden byte parity)
            s.aggr.stage.bump_hidden('nstackedbatches', 1)
        _note_h2d(nbytes)
        lead._note_dispatch(lead._ring.release(slot, lead._compute),
                            nbytes)
        self._nbatch += 1
        if self._nbatch % SYNC_EVERY_BATCHES == 0:
            lead._sync_device()
        return True


def make_stack(scanners):
    """A DeviceScanStack when the scanner set supports it (>= 2 device
    scans), else None (callers keep the per-scan loop).  DN_STACK=0
    disables stacking (per-scan device folds still run)."""
    if os.environ.get('DN_STACK', '1') == '0':
        return None
    if len(scanners) < 2:
        return None
    if not all(isinstance(s, DeviceScan) and s.STACKABLE
               for s in scanners):
        return None
    return DeviceScanStack(scanners)


class _ShadowProbe(object):
    """Background device audition: replays copies of recent batch
    snapshots through scratch DeviceScans (results discarded) to measure
    the device rate — staging, upload and fold, without the parse —
    while the MT host executor keeps owning the stream.  The first batch
    is warmup (the first CUDA calls of the process, and the first build
    of the kernel, can land here); the rest run back-to-back between
    two barriers on the device."""

    COLLECT = 5      # 1 warmup + 4 measured batches

    def __init__(self, make_scans, make_provider, make_weights,
                 make_alive=None):
        self.make_scans = make_scans
        self.make_provider = make_provider
        self.make_weights = make_weights
        # production may pass a non-None alive mask (the build path's
        # shared datasource-filter eval); the replay must match, or the
        # staged upload profile differs from what the takeover runs
        self.make_alive = make_alive or (lambda n: None)
        self.items = []
        self.rate = None
        self.replay_s = None      # the audition's own wall time
        # the replay thread's CPU seconds over the same span: far below
        # replay_s when the thread waited (for the interpreter lock or
        # a core) behind the stream's host workers
        self.replay_cpu_s = None
        self.failed = False
        # an exception of the replay's device work: a fault, raised on
        # the stream thread (_raise_audition_fault)
        self.error = None
        self.done = False
        self.closed = False
        # monotonic times: created, batches all in, replay started,
        # replay done (the route reports them against the scan's start)
        self.times = [time.monotonic(), None, None, None]
        self._event = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def feed(self, snap, n):
        if self.done or self.closed or len(self.items) >= self.COLLECT:
            return
        self.items.append((snap, n))
        if len(self.items) >= self.COLLECT:
            self.times[1] = time.monotonic()
            self._event.set()

    def close(self):
        """End-of-stream / decision-made: wake the thread so it exits
        (failing fast on an incomplete collection, or between replayed
        batches) instead of holding batch snapshots for the wait
        timeout."""
        self.closed = True
        self._event.set()

    def collected(self):
        """All COLLECT batches are in and the replay may be running."""
        return self._event.is_set() and not self.closed

    def join(self, timeout):
        self._thread.join(timeout)

    def _run(self):
        try:
            # batches arrive one per flush; collect-then-run so queue
            # gaps never pollute the rate measurement
            self._event.wait(timeout=600.0)
            if self.closed or len(self.items) < 2:
                self.items = []
                self.failed = True
                return
            t_start = (time.monotonic(), time.thread_time())
            self.times[2] = t_start[0]
            scans = self.make_scans()
            for s in scans:
                s._backend_ok = True
            # multi-metric auditions replay through the stack, the
            # thing production runs after a build takeover
            stack = make_stack(scans)
            dev = scans[0].device if scans else None
            if dev is not None and dev.type == 'cuda':
                # the replay's own compute stream, current on this thread
                # (the scratch scans and K1 launch on it); its barriers
                # are its own events, so it never waits on the live
                # stream's work nor the live stream on it
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    self._replay(scans, stack, t_start)
            else:
                self._replay(scans, stack, t_start)
        except Exception as e:
            self.error = e
            self.failed = True
        finally:
            self.items = []     # release the pinned snapshots
            self.times[3] = time.monotonic()
            self.done = True

    def _replay(self, scans, stack, t_start):
        """The warmup batch, then the rest back-to-back between two of
        the scratch scans' own barriers: sets rate and replay_s, or
        failed."""
        items = self.items

        def run_one(snap, n):
            provider = self.make_provider(snap)
            weights = self.make_weights(snap, n)
            alive = self.make_alive(n)
            if stack is not None:
                return stack._process_device(provider, weights, alive)
            for s in scans:
                if not s._try_device(provider, weights, alive):
                    return False
            return True

        if not run_one(*items[0]):       # warmup
            self.failed = True
            return
        for s in scans:
            s._sync_device()
        t0 = time.monotonic()
        seen = 0
        for snap, n in items[1:]:
            if self.closed or not run_one(snap, n):
                self.failed = True
                return
            seen += n
        for s in scans:
            s._sync_device()
        elapsed = time.monotonic() - t0
        self.rate = seen / elapsed if elapsed > 0 else float('inf')
        self.replay_s = time.monotonic() - t_start[0]
        self.replay_cpu_s = time.thread_time() - t_start[1]


def _raise_audition_fault(sp):
    """An audition whose device work raised is a fault of the device
    path, never a reason to stay quietly on the host: raise it on the
    stream thread.  (A stream that ended before the batches were in,
    or a batch the device path cannot take, only fails the audition.)"""
    if sp.error is not None:
        from .errors import DNError
        raise DNError('device audition failed', cause=sp.error)


class AutoDeviceScan(DeviceScan):
    """Auto-mode DeviceScan (DN_ENGINE=auto on a CUDA device): small
    scans stay on the host (the device is not even probed below the
    threshold), large ones escalate to the device mid-stream (host
    batches were merged immediately, so insertion order is preserved),
    and a probation window de-escalates if the device turns out slower
    than the host.

    Auto never blocks the stream on the device: the probe runs on a
    background thread while the host engine keeps scanning, and the
    switch happens only once (a) the probe has succeeded, (b) the
    stream's byte progress suggests enough work remains, and (c) — on
    the MT path — the device has WON a shadow audition (copies of live
    batches replayed through scratch DeviceScans on a background
    thread) by SHADOW_MARGIN over the observed host rate.  Host-engine
    batches aggregate on numpy, as the reference's auto mode does.

    The constants are the reference's, tuned on its TPU rig; the port
    keeps them as defaults until they are measured on the card."""

    ESCALATE_RECORDS = 1 << 19
    REQUIRE_ACCELERATOR = True
    PROBATION_RECORDS = 1 << 17
    AUTO_STREAM = True
    # minimum estimated remaining host-engine seconds to justify the
    # switch
    MIN_REMAINING_SECONDS = 3.0
    # without a size hint (stdin pipes), switch only deep into a stream
    UNKNOWN_SIZE_RECORDS = 4 << 20
    # shadow audition: take over only when the measured device rate
    # beats the observed host rate by this factor
    SHADOW_MARGIN = 1.15
    # warm start: a persisted win for this query shape escalates much
    # earlier; the full shape+backend key still gates the takeover
    WARM_ESCALATE_RECORDS = 1 << 16
    WARM_MIN_REMAINING_SECONDS = 0.75
    # the stream waits for a started probe and for an audition whose
    # batches are all in, instead of racing them against its end: a
    # deterministic takeover for checks (the stream stalls meanwhile)
    AWAIT_DECISION = False

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None):
        DeviceScan.__init__(self, query, time_field, pipeline,
                            ds_filter=ds_filter, device=device)
        # host-engine batches stay on numpy
        self.agg_device = None

    def enable_shadow(self, make_scans, make_provider, make_weights,
                      make_alive=None):
        """MT-path integration: before the device may take the stream,
        it must win an audition on copies of live batches (fed via
        shadow_feed) against the observed host rate."""
        self._shadow_ctx = (make_scans, make_provider, make_weights,
                            make_alive)

    def shadow_feed(self, snap, n):
        sp = self._shadow
        if sp is not None and not sp.done:
            sp.feed(snap, n)

    def _audition_shape(self):
        """The device-program-shaping query structure (breakdown plans,
        predicate ASTs, synthetic fields, time-boundedness): the
        backend-independent half of the audition key."""
        plans = [(p.kind, p.name, p.field, p.step)
                 for p in (self._plans or [])]
        return jsv.json_stringify([
            plans,
            jsv.json_stringify(self.ds_pred.ast)
            if self.ds_pred is not None else None,
            jsv.json_stringify(self.user_pred.ast)
            if self.user_pred is not None else None,
            [[s['name'], s['field']] for s in self.synthetic],
            self.time_bounds is not None,
        ])

    def _audition_key(self):
        """Cache key of this scan's audition: the query shape plus the
        device identity.  Initializes CUDA (_backend_id), so only call
        it after the probe succeeded."""
        return self._audition_shape() + '@' + _backend_id(self.device)

    def _warm_hint(self):
        """Memoized shape-only audition-cache lookup, safe before the
        probe: it only tunes how eagerly this scan escalates."""
        hint = getattr(self, '_warm_hint_memo', ())
        if hint == ():
            hint = audition_cache_shape_hint(self._audition_shape())
            self._warm_hint_memo = hint
        return hint

    def _escalate_records(self):
        if self._warm_hint() is True:
            return min(self.ESCALATE_RECORDS,
                       self.WARM_ESCALATE_RECORDS)
        return self.ESCALATE_RECORDS

    def _record_crossover(self, won, rate):
        audition_cache_put(self._audition_key(), won,
                           device_rate=rate,
                           host_rate=self._host_rate)

    def _engage_device(self):
        rv = self._decide()
        if rv or not self.AWAIT_DECISION:
            return rv
        if self._probe_thread is not None:
            self._probe_thread.join(probe_deadline_s())
            rv = self._decide()
        sp = self._shadow
        if not rv and sp is not None and sp.collected():
            sp.join(probe_deadline_s())
            rv = self._decide()
        return rv

    def _decide(self):
        if self._escalated:
            return bool(self._backend_ok)
        if not self._worth_switching():
            # nothing to gain: don't even start the probe thread
            return False
        if self._backend_ok is None:
            if self._probe_thread is None:
                self._probe_thread = threading.Thread(
                    target=self._async_probe, daemon=True)
                self._probe_started = time.monotonic()
                self._probe_thread.start()
            result = self._probe_result
            if result is None:
                # wedge armor: stop waiting for a probe thread stuck
                # past the deadline (the scan already runs on the host)
                if time.monotonic() - self._probe_started > \
                        probe_deadline_s():
                    LOG.info('device probe exceeded deadline; '
                             'staying on host',
                             deadline_s=probe_deadline_s())
                    self.probe_status = 'timeout'
                    self._disabled = True
                return False     # still probing; host path continues
            self._probe_thread = None
            if isinstance(result, Exception):
                # a probe that raised is a fault of the device, not a
                # verdict (a refusal, or a timeout, keeps the host)
                from .errors import DNError
                self.probe_status = 'error'
                self._disabled = True
                raise DNError('device %s failed its probe' % self.device,
                              cause=result)
            self._backend_ok = result
            self.probe_status = 'ok' if result else 'refused'
            if not result:
                self._disabled = True
                return False
        if not self._backend_ok:
            return False
        ctx = self._shadow_ctx
        if ctx is not None:
            sp = self._shadow
            if sp is None:
                # persisted verdict from a previous identically-shaped
                # run on this device: skip the shadow audition
                cached = audition_cache_get(self._audition_key())
                self.route['cached_verdict'] = cached
                if cached is False:
                    LOG.info('cached audition verdict: device loses; '
                             'staying on host')
                    self._disabled = True
                    return False
                if cached is True:
                    hr = self._current_host_rate()
                    if hr is not None:
                        self._host_rate = hr   # probation baseline
                    LOG.info('cached audition verdict: device wins; '
                             'taking over stream')
                else:
                    LOG.debug('device audition started',
                              records_seen=self._records_seen)
                    self._shadow = _ShadowProbe(*ctx)
                    return False
            else:
                if not sp.done:
                    return False
                won, hr = self._conclude_audition(sp)
                if not won:
                    self._disabled = True
                    return False
                if hr is not None:
                    self._host_rate = hr   # probation baseline
        self._escalated = True
        self._note_escalated()
        LOG.info('escalated to device path',
                 records_seen=self._records_seen)
        return True

    def _conclude_audition(self, sp, at_finish=False):
        """The verdict of a finished audition, recorded in the route and
        persisted in the audition cache: (won, the host rate it was held
        to, None when unknown).  A replay that faulted raises
        (_raise_audition_fault)."""
        _raise_audition_fault(sp)
        if sp.failed or sp.rate is None:
            LOG.info('device audition failed; staying on host')
            self.route['audition'] = {'failed': True}
            return False, None
        hr = self._current_host_rate()
        won = hr is None or sp.rate >= hr * self.SHADOW_MARGIN
        self.route['audition'] = {
            'won': won, 'device_rate': _rate_field(sp.rate),
            'host_rate': _rate_field(hr), 'margin': self.SHADOW_MARGIN,
            'replay_s': sp.replay_s, 'replay_cpu_s': sp.replay_cpu_s,
            'at_finish': at_finish,
            # seconds from the scan's start: the audition created, its
            # batches all in, its replay started and done, the verdict
            'timeline_s': [None if t is None else round(t - self._t0, 4)
                           for t in sp.times + [time.monotonic()]]}
        audition_cache_put(self._audition_key(), won, device_rate=sp.rate,
                           host_rate=hr)
        LOG.info('device %s audition' % ('won' if won else 'lost'),
                 device_rate=_rate_field(sp.rate),
                 host_rate=_rate_field(hr), margin=self.SHADOW_MARGIN,
                 at_finish=at_finish)
        return won, hr

    def finish(self):
        """As DeviceScan.finish; an audition whose replay completed after
        the stream's last decision point still concludes here: its
        verdict is recorded and persisted, so the next run of this shape
        starts from it instead of racing the same replay again."""
        sp = self._shadow
        if sp is not None and self.route['audition'] is None:
            sp.close()
            sp.join(probe_deadline_s())
            if sp.done and (sp.rate is not None or sp.error is not None):
                self._conclude_audition(sp, at_finish=True)
        return DeviceScan.finish(self)

    def _current_host_rate(self):
        if self._t0 is None or not self._host_records:
            return None
        elapsed = time.monotonic() - self._t0
        return self._host_records / elapsed if elapsed > 0 else None

    def _async_probe(self):
        """Background probe; publishes a bool, or the exception it
        raised, to _probe_result (single assignment, read by the stream
        thread)."""
        try:
            self._probe_result = self._probe_with_retry()
        except Exception as e:
            self._probe_result = e

    def _worth_switching(self):
        """Estimated remaining host-engine time exceeds the switch
        overhead: from the stream's byte progress when available, else
        a deep-stream record threshold.  A warm cached win lowers both
        bars."""
        if self._t0 is None or not self._records_seen:
            return False
        elapsed = time.monotonic() - self._t0
        if elapsed <= 0:
            return False
        warm = self._warm_hint() is True
        rate = self._records_seen / elapsed
        prog = self._progress
        if prog and prog[0] > 0 and prog[1] > 0:
            est_total = self._records_seen * (prog[1] / prog[0])
            remaining = max(0.0, est_total - self._records_seen)
            return remaining / rate >= (
                min(self.MIN_REMAINING_SECONDS,
                    self.WARM_MIN_REMAINING_SECONDS)
                if warm else self.MIN_REMAINING_SECONDS)
        return self._records_seen >= (
            min(self.UNKNOWN_SIZE_RECORDS, self.WARM_ESCALATE_RECORDS)
            if warm else self.UNKNOWN_SIZE_RECORDS)


def scan_class(engine, device=None):
    """The scan implementation for an engine: 'device' (DN_ENGINE=jax)
    forces DeviceScan; 'auto' runs AutoDeviceScan on a CUDA device and
    the host VectorScan when the caller asked for the CPU (the
    reference's no-accelerator branch); 'vector' pins VectorScan.
    Initializes no device: auto probes lazily, past its threshold."""
    if engine == 'device':
        return DeviceScan
    if engine == 'auto':
        dev = torch.device('cuda' if device is None else device)
        return AutoDeviceScan if dev.type == 'cuda' else VectorScan
    return VectorScan
