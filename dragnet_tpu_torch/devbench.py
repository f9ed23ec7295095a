"""Kernel-resident device microbenchmark: what does the card do, apart
from what the host costs?

Counterpart of dragnet_tpu/devbench.py `kernel_bench`.  It separates
three quantities that end-to-end records/s mixes:

* the resident fold: the production fold (`DeviceScan._fold_staged`:
  the scan program K2 — predicates, masks, bucketize, key fusion, the
  first-occurrence min and the counters — adding the weights into the
  scan's resident accumulator itself or handing its fused key to the
  one-hot kernel K1) iterated over one batch's per-record inputs that
  the benchmark uploaded once and owns: no parse, no transfer;
* H2D and D2H: the same batch's real per-record arrays through the
  scan's staging ring (page-locked slot, one non_blocking copy, as the
  scan uploads every batch), and a fetch of the accumulator;
* the reupload contrast: each fold preceded by a fresh staging of every
  per-record input (the per-request, non-resident shape);
  residency_speedup = reupload time / resident time.

The reference counts the TPU's one-hot matmul FLOPs (its block
padding) against a TPU bf16 peak for an MFU figure.  K1 on Hopper is an
integer histogram with no matmul, so the port reports bytes instead:
`bound_ms` is the reference's traffic model (every per-record input
byte read once, the accumulator read and written once) at the card's
peak memory bandwidth (PEAK_HBM_BYTES_PER_S, by device name; None on
another device and on the CPU), and `bound_share` is bound_ms over the
measured ms per batch.  `onehot_kernel` (the reference's `pallas`) is
true only when K1 launched once per fold of the resident loop
(`kernel_launches`, counted from cuda_kernels.launches), and
`body_kernel` only when K2 did (`body_launches`).  The port pads
no batch (device_scan._StagingRing has no padding floor), so
`padded_records` equals `records` and `h2d_bytes_per_record` is smaller
than the reference's, whose rows are padded to its batch floor.

Set DN_BENCH_TRACE=<dir> to record a torch.profiler trace of the
resident loop (CUDA activity on the card) as a Chrome trace in <dir>.
"""

import contextlib
import gc
import os
import time

import numpy as np
import torch

from . import native as mod_native
from . import query as mod_query
from . import scan_program
from .device_scan import DeviceScan, uses_kernel
from .engine import NativeColumns, BATCH_SIZE
from .ops import cuda_kernels, resolve_device
from .vpipe import Pipeline

# peak device-memory bandwidth by device-name substring (NVIDIA's
# H100 data sheets), first match wins
PEAK_HBM_BYTES_PER_S = (
    ('h100 nvl', 3.9e12),
    ('h100 pcie', 2.0e12),
    ('h100 80gb hbm3', 3.35e12),
    ('h100 sxm', 3.35e12),
)

H2D_REPS = 5


def peak_hbm_bytes_per_s(device_kind):
    kind = (device_kind or '').lower()
    for sub, peak in PEAK_HBM_BYTES_PER_S:
        if sub in kind:
            return peak
    return None


def _one_batch_parser(datafile, scan, max_records):
    """A native parser holding one batch of real records from
    datafile, projected for `scan`."""
    proj = scan.projection()
    parser = mod_native.NativeParser([p for p, h, d in proj],
                                     [h for p, h, d in proj],
                                     [d for p, h, d in proj])
    nl = 0
    chunks = []
    with open(datafile, 'rb') as f:
        while nl < max_records:
            chunk = f.read(1 << 22)
            if not chunk:
                break
            end = len(chunk)
            c = chunk.count(b'\n')
            if nl + c > max_records:
                # trim to exactly max_records lines
                need = max_records - nl
                pos = -1
                for _ in range(need):
                    pos = chunk.index(b'\n', pos + 1)
                end = pos + 1
                c = need
            nl += c
            chunks.append(chunk[:end])
    data = b''.join(chunks)
    data = data[:data.rfind(b'\n') + 1]
    parser.parse(data)
    return parser


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _to_host(tensors):
    return [t.cpu().numpy() for t in tensors]


@contextlib.contextmanager
def _trace(dev):
    """torch.profiler around the resident loop when DN_BENCH_TRACE
    names a directory; its Chrome trace lands there.  A profiler that
    fails raises."""
    tdir = os.environ.get('DN_BENCH_TRACE')
    if not tdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(tdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        tdir, 'devbench_%d_%d.json' % (os.getpid(), time.time_ns())))


def kernel_bench(datafile, query_conf=None, iters=32, max_records=None,
                 device=None, capture=None):
    """Run the kernel-resident benchmark on the first `max_records`
    (default: one scan batch) records of `datafile`; returns a dict of
    measured quantities (see the module docstring), or None when the
    native parser is missing or the device path refuses the batch.

    Runs on `device`, else DN_TORCH_DEVICE, else CUDA; asking for CUDA
    without it raises DNError.  `capture`, a dict, receives host copies
    of the resident accumulator after the loop ('resident'), one fold
    of the batch into a fresh accumulator through the plain version of
    the scan program, scan_program.scan_body_ref, with index_add_ and no
    kernel ('plain'; None in sparse mode), and the
    resident accumulator's points as the scan's own flush emits them
    ('points'), for checks: iters + 1 folds of one batch."""
    dev = resolve_device(device or os.environ.get('DN_TORCH_DEVICE') or
                         'cuda')
    if mod_native.get_lib() is None:
        return None
    q = mod_query.query_load(dict(query_conf or {}))
    scan = DeviceScan(q, None, Pipeline(), device=dev)
    try:
        return _bench(scan, dev, datafile, iters,
                      max_records or BATCH_SIZE, capture)
    finally:
        # tidy up: device memory returns to its level.  The scan and
        # its folds' inputs are freed by reference counting (no
        # reference cycles hold them; the collection is a guard); the
        # staging ring's device buffers were marked used on its copy
        # stream, so the caching allocator frees them once it has
        # processed that stream's events, which empty_cache() does
        del scan
        gc.collect()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()


def _bench(scan, dev, datafile, iters, max_records, capture):
    parser = _one_batch_parser(datafile, scan, max_records)
    n = parser.batch_size()
    if n == 0:
        return None
    scan.capture_next = True
    if not scan._try_device(NativeColumns(parser),
                            np.ones(n, dtype=np.float64), None):
        return None
    inputs, staged, use_kernel = scan.captured
    _, profile, caps, ns, _ = staged
    sparse_cap = profile[-1]
    # the capturing batch's own fold: done with, not measured
    _sync(dev)
    scan._acc = None
    scan._acc_batch = 0
    scan._pipe.clear()

    rows = {k: np.ascontiguousarray(v).reshape(-1)
            for k, v in inputs.items() if isinstance(v, np.ndarray)}
    h2d_bytes = sum(v.nbytes for v in rows.values())

    # ---- H2D: the batch's per-record arrays through the staging ring
    # (page-locked slot, one non_blocking copy), as the scan uploads
    t0 = time.monotonic()
    for _ in range(H2D_REPS):
        _, nbytes, slot = scan._upload_inputs(inputs)
        _sync(dev)
        scan._ring.release(slot, scan._compute)
    h2d_s = (time.monotonic() - t0) / H2D_REPS

    # ---- the resident loop: per-record tensors the bench uploaded once
    # and owns (never a ring slot, which the next staging rewrites),
    # tables as the scan keeps them resident
    args = {k: v for k, v in inputs.items()
            if not isinstance(v, np.ndarray)}
    for k, v in rows.items():
        args[k] = torch.from_numpy(v).to(dev)
    _sync(dev)

    def fold(fargs):
        if sparse_cap:
            # the same batch again: at most n keys occupy the set
            scan._sparse_ub = min(sparse_cap, n) + n
        scan._fold_staged(staged, fargs)

    fold(args)                              # warm
    _sync(dev)
    k0 = cuda_kernels.launches['onehot_dense']
    b0 = cuda_kernels.launches['scan_body']
    ev = None
    if dev.type == 'cuda':
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    with _trace(dev):
        t0 = time.monotonic()
        if ev is not None:
            ev[0].record()
        for _ in range(iters):
            fold(args)
        if ev is not None:
            ev[1].record()
        _sync(dev)
        kernel_s = (time.monotonic() - t0) / iters
    kernel_launches = cuda_kernels.launches['onehot_dense'] - k0
    body_launches = cuda_kernels.launches['scan_body'] - b0
    device_ms = ev[0].elapsed_time(ev[1]) / iters if ev else None
    resident = scan._acc

    # ---- the reupload contrast: every fold after a fresh staging of
    # each per-record input, into a fresh accumulator
    scan._acc = None
    scan._acc_batch = 0
    rep_iters = max(1, iters // 4)
    t0 = time.monotonic()
    for _ in range(rep_iters):
        staged_args, _, slot = scan._upload_inputs(inputs)
        fold(staged_args)
        scan._ring.release(slot, scan._compute)
    _sync(dev)
    reupload_s = (time.monotonic() - t0) / rep_iters
    scan._acc = None

    # ---- D2H: fetch the resident accumulator
    d2h_bytes = sum(t.numel() * t.element_size() for t in resident)
    t0 = time.monotonic()
    for t in resident:
        t.cpu()
    d2h_s = time.monotonic() - t0

    if capture is not None:
        _capture(capture, scan, staged, args, resident, sparse_cap)
    resident = None

    # ---- accounting: per fold, every per-record input byte read once
    # and the accumulator (the D2H bytes) read and written once, the
    # reference's model
    hbm_bytes = h2d_bytes + 2 * d2h_bytes
    kind = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    peak = peak_hbm_bytes_per_s(kind)
    bound_ms = hbm_bytes / peak * 1e3 if peak else None
    kernel_ms = kernel_s * 1e3
    return {
        'records': n,
        'padded_records': n,
        'segments': ns,
        'onehot_kernel': bool(use_kernel) and kernel_launches == iters,
        'kernel_launches': kernel_launches,
        'body_kernel': body_launches == iters,
        'body_launches': body_launches,
        'kernel_records_per_sec': n / kernel_s,
        'kernel_ms_per_batch': kernel_ms,
        'device_ms_per_batch': device_ms,
        'hbm_gb_per_sec': hbm_bytes / kernel_s / 1e9,
        'h2d_gb_per_sec': h2d_bytes / h2d_s / 1e9,
        'h2d_bytes_per_record': h2d_bytes / n,
        'd2h_mb_per_sec': d2h_bytes / d2h_s / 1e6,
        'reupload_records_per_sec': n / reupload_s,
        'residency_speedup': reupload_s / kernel_s,
        'bound_ms': bound_ms,
        'bound_share': bound_ms / kernel_ms if bound_ms else None,
        'device_kind': kind,
        'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
    }


def _capture(capture, scan, staged, args, resident, sparse_cap):
    """Fill the test seam (see kernel_bench)."""
    n, profile, caps, ns, _ = staged
    capture['resident'] = _to_host(resident)
    capture['plain'] = None
    if not sparse_cap:
        scan._acc = None
        scan._ensure_acc(caps, ns)
        dense, first, cvec = scan._acc
        prog = scan._program(profile, caps, ns, scan_program.MODE_DENSE)
        scan_program.scan_body_ref(prog, args, n, dense, first, cvec)
        capture['plain'] = _to_host(scan._acc)
    scan._acc = resident
    scan.finish()
    capture['points'] = scan.aggr.points()
