#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--records N] [--seed S] [--reps R] [--json F]

Phases, each ending in torch.cuda.synchronize() so a fault shows where
it happened; any failed check exits non-zero:

1. build   the one-hot aggregation kernel (ops/csrc/onehot_agg.cu) from
           the sources in this checkout, with nvcc; prints ptxas's
           registers, shared memory and spills (-Xptxas -v).
2. kernel  the kernel against its plain torch version, exactly, at the
           four shapes of tests/test_pallas.py (through onehot_dense),
           at one batch (65,536 records) with each kernel query's caps,
           over a sweep at the main path's batch size (74,800 records x
           256-4,096 segments, unit weights) on uniform keys, on keys
           all in one bin and on linear-timestamp runs, at n = 0 and 1,
           into a non-zero accumulator with signed weights and i64 keys,
           and at 2,000,000 records x 4,096 segments.  Each timed shape
           prints the kernel's, the plain version's and the yardstick's
           times (device and eager) and the bound; the yardstick is
           index_add_ of the same fused key into a preallocated i64
           accumulator, the same function.  Beside the 2,000,000-record
           call, two floors (any launch; a copy of the same keys), and
           the wrapper's private stream lookup checked against
           torch.cuda.current_stream, with the host cost of each.
3. data    N generated muskie request-log records (native/dngen.cc) in a
           temporary directory, with a DRAGNET_CONFIG holding one file
           datasource (timeField=time, filter {"ne":["host","zzz"]}),
           and a cold pass: the three queries over 20,000 records, once,
           which pays the process's one-time CUDA warm-up (timed
           separately) before the measured main path.
4. scans   `scan` through the port's CLI code path, in-process, on the
           card, for three queries; each output (--points and
           --counters) must equal the port's host engine on the same
           file byte for byte, every batch must run on the device, the
           kernel must launch once per batch on the two kernel queries
           and never on the scatter query.
5. sparse  two high-cardinality scans on the card (the sparse program:
           fused i64 keys sort-merged into a resident set): the
           per-minute timestamp x host x url x latency query, which
           starts dense and turns sparse as its time window grows, and a
           wider query without a time window, sparse from its first
           batch, whose ~1.8M unique tuples make the guard grow the set
           past its 2^20 initial capacity.  Every batch must run on the
           device, the sparse fold must run (its call count), the set
           must grow, and the output must equal the host engine's byte
           for byte.  Prints records/s of both engines, the fold's
           device ms per batch (CUDA events) and the capacity reached;
           beside it, the fold alone at 2^20 and 2^22 slots (nearly
           full, one main-path batch) with its sort's share.
6. build   three metrics (metric-add), `build --interval=hour
           --counters` on the card through the CLI and with the host
           engine into a second tree: the trees (shards and integrity
           catalog) must be byte-identical, every batch must fold
           through the stack (DeviceScanStack), one metric on each fold
           route (one-hot kernel, index_add_, sparse), the kernel
           launching once per stacked batch; then `index-scan` on both
           engines, identical.  Prints wall s and records/s of both
           builds, the index writer's share, shards and bytes, and
           whether libdnindex.so was loaded.
7. query   `dn query` on the card: N records spread over 30 days, the
           three metrics of phase 6 built on the card with
           --interval=hour (720 shards) and --interval=day (30 shards),
           then QUERY_CASES through the CLI (--points --counters) on the
           card and with the port's host engine on the same tree,
           byte for byte.  The stacked queries must aggregate on the
           device (the hidden `index device sums` counter, a non-zero
           dispatch count of the slot-packed fold); the bare query must
           take its host route; the windowed query must prune.  Prints
           per query the wall time of both engines, the fold's device
           ms per dispatch (CUDA events), dispatches, upload bytes, the
           host seconds of load / sort / aggregate and the fold's
           bound, and a `query` JSON line.
8. main    the kernel again, on the fused keys the main path gave it:
   keys    the largest batch of each kernel query at each segment count
           (the time window, and with it the accumulator, grows during
           the timestamp query), captured in phase 4.
9. result  the card's name and power limit (nvidia-smi), a `kernels`
           JSON line (launches on the main path, the build and the
           query phase, times, bound), and as the last line
           {"ok": true, "device": {...}}.

Without CUDA, or without the rest of the repository beside it, the
script exits non-zero and prints no result.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12      # H100 SXM: half the 67 TFLOP/s fp32 rate

DEVICE = 'cuda'
KERNEL_SOURCE = 'dragnet_tpu_torch/ops/csrc/onehot_agg.cu'
KERNEL_REPLACES = 'dragnet_tpu/ops/pallas_kernels.py:102'

PALLAS_SHAPES = [((8, 64), 1000), ((3, 5, 7), 4096), ((513,), 700),
                 ((8, 16, 32), 8192)]
COLD_RECORDS = 20000

# one batch with each kernel query's staged caps, unit weights (as the
# main path calls it)
SLICE_SHAPES = [((8, 32), 65536), ((256, 16), 65536)]

# the main path's batch (16 MiB reads of ~225-byte records) and every
# segment count the gate sends to the kernel
BATCH_RECORDS = 74800
SWEEP_SEGMENTS = [256, 512, 1024, 2048, 4096]
# one call at the bound-share shape: unit weights keep the total < 2^24;
# the keys rotate over copies larger than the 50 MB L2 cache
LARGE_RECORDS = 2000000
LARGE_SEGMENTS = 4096
L2_BYTES = 50 << 20

# (name, scan arguments, expected route): the large-scan query of the
# repository's benchmark, its small-accumulator query, and the synthetic
# date column with the time masks
QUERIES = [
    ('host x method x operation x latency',
     ['-b', 'host,req.method,operation,latency[aggr=quantize]',
      '-f', '{"ne": ["res.statusCode", 599]}'], 'scatter'),
    ('host x latency',
     ['-b', 'host,latency[aggr=quantize]'], 'kernel'),
    ('timestamp(60s) x statusCode >= 500',
     ['-b', 'timestamp[field=time,date,aggr=lquantize,step=60],'
      'res.statusCode', '-f', '{"ge": ["res.statusCode", 500]}'],
     'kernel'),
]


# phase 5: (name, scan arguments, expected routes).  The first is the
# per-minute breakdown that passes the 2^24 dense budget once its time
# window passes 128 minutes; its time-window epochs hold at most ~710k
# records each (every window growth flushes), too few uniques to fill
# the set.  Its nspillrecords counter differs from the host engine's
# where the reference documents it (DeviceScan._build_static): the
# host decides dense vs sparse per batch on the exact radices (and
# spills any batch whose key space passes 4x its rows), the device on
# pow2 caps against 2^24.  The second has no time window and passes
# 2^24 either way: one epoch of 2M records and ~1.8M unique tuples, so
# the guard must grow the set.
SPARSE_QUERIES = [
    ('timestamp(60s) x host x url x latency',
     ['-b', 'timestamp[field=time,date,aggr=lquantize,step=60],host,'
      'req.url,latency[aggr=quantize]'], 'dense then sparse'),
    ('host x url x op x method x status x lat x dlat',
     ['-b', 'host,req.url,operation,req.method,res.statusCode,'
      'latency[aggr=quantize],dataLatency[aggr=quantize]'],
     'sparse, grows'),
]
SPARSE_BENCH_CAPS = [1 << 20, 1 << 22]

# phase 6: (metric, breakdowns, fold route at --interval=hour, where
# the hourly __dn_ts key is prepended)
BUILD_METRICS = [
    ('byhour', 'timestamp[field=time,date,aggr=lquantize,step=3600],host',
     'kernel'),
    ('requests', 'timestamp[field=time,date,aggr=lquantize,step=60],'
     'req.method,res.statusCode,latency[aggr=quantize]', 'index_add'),
    ('byurl', 'timestamp[field=time,date,aggr=lquantize,step=60],host,'
     'req.url,latency[aggr=quantize]', 'sparse'),
]

# phase 7: the records spread over 30 days from 2014-05-01 UTC, and
# (name, query arguments, the aggregation route expected on the card).
# Each resolves to one of BUILD_METRICS (find_metric takes the first
# that covers the breakdowns and the filter's fields): byurl, requests,
# requests, byurl and byhour.
QUERY_MIN_MS = 1398902400000
QUERY_DAYS = 30
QUERY_CASES = [
    ('a host x url, day', ['-b', 'host,req.url', '--interval=day'],
     'device'),
    ('b method x status >= 500, hour',
     ['-b', 'req.method,res.statusCode', '-f',
      '{"ge":["res.statusCode",500]}', '--interval=hour'], 'device'),
    ('c (b) over one week, hour',
     ['-b', 'req.method,res.statusCode', '-f',
      '{"ge":["res.statusCode",500]}', '--interval=hour',
      '--after', '2014-05-08', '--before', '2014-05-15'], 'device'),
    ('d host x url x latency, hour',
     ['-b', 'host,req.url,latency[aggr=quantize]', '--interval=hour'],
     'device'),
    ('e no breakdowns, hour', ['--interval=hour'], 'host: no breakdowns'),
]
# K7's least traffic: each row's local code and weight (16 B), each
# translation entry (8 B), each accumulator segment read and written
# (16 B)
K7_ROW_BYTES, K7_TAB_BYTES, K7_SEG_BYTES = 16, 8, 16


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit('chip_smoke: FAILED: %s' % msg)


def cuda_time_ms(fn, reps):
    """(device ms, eager ms) per call of fn.  Device time: reps calls
    captured in one CUDA graph and replayed between CUDA events, so the
    host's per-call Python and launch cost is not counted.  Eager time:
    the same calls issued one by one, as a caller issues them."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / reps
    del graph
    return device, eager


def kernel_inputs(radices, n, seed, unit_weights):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, r, n)
                      for r in radices]).astype(np.int32)
    w = None if unit_weights else rng.integers(-3, 10, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    dev = torch.device(DEVICE)
    return (torch.from_numpy(codes).to(dev),
            None if w is None else torch.from_numpy(w).to(dev),
            torch.from_numpy(alive).to(dev))


def fused_keys(kind, ns, n, seed=1):
    """i32 fused keys [n] with dead rows at ns, as the device scan gives
    them: 'uniform' (10 % dead), 'one bin' (every live row on one bin,
    the worst contention), or 'linear ts' (a timestamp(60s) x
    statusCode batch: linear timestamps put ~7 minutes in one batch, so
    a warp's records share one or two minute buckets; 7 status codes,
    4 of them dead under the >= 500 filter)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == 'uniform':
        keys = rng.integers(0, ns, n)
        keys[rng.random(n) < 0.1] = ns
    elif kind == 'one bin':
        keys = np.full(n, ns // 3)
        keys[rng.random(n) < 0.1] = ns
    else:
        minute = np.arange(n) * 7 // max(n, 1)
        code = rng.integers(0, 7, n)
        keys = np.where(code < 4, ns, (minute * 16 + code) % ns)
    return torch.from_numpy(keys.astype(np.int32)).to(DEVICE)


def kernel_bound_ms(radices, n, weighted):
    """Least time for the codes entry: its bytes (codes, weights, alive
    read once; the i64 output written once) over the memory rate, or its
    integer operations (a multiply-add per column and a compare per
    record) over the int32 rate, whichever is larger."""
    ns = 1
    for r in radices:
        ns *= r
    nbytes = n * (4 * len(radices) + (4 if weighted else 0) + 1) + 8 * ns
    nops = n * (2 * len(radices) + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def into_bound_ms(ns, n, key_bytes, weighted):
    """Least time for onehot_dense_into: each fused key (and weight)
    read once, the i64 accumulator read and written once, over the
    memory rate; or a compare and an add per record over the int32
    rate, whichever is larger."""
    nbytes = n * (key_bytes + (4 if weighted else 0)) + 16 * ns
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / INT32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_into(ck, label, ns, fused, w, reps, out0=None, copies=1):
    """onehot_dense_into against its plain version on the card at one
    shape, exactly (into a copy of out0, zeros by default), then the
    device and eager times per call of the kernel, the plain version and
    the yardstick: index_add_ of the same fused key (out-of-range rows
    sent to a pad slot) into a preallocated i64 accumulator.  With
    copies > 1 the calls cycle over that many copies of the keys, so
    they find them out of L2 as a cold caller would."""
    import itertools
    import torch
    dev = fused.device
    if out0 is None:
        out0 = torch.zeros(ns, dtype=torch.int64, device=dev)
    got = ck.onehot_dense_into(out0.clone(), fused, w)
    want = ck.onehot_dense_into_ref(out0.clone(), fused, w)
    torch.cuda.synchronize()
    n = fused.shape[0]
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          'one-hot kernel differs from its plain version at %s, %d '
          'segments x %d (max abs err %d)' % (label, ns, n, err))
    keys = [fused] + [fused.clone() for _ in range(copies - 1)]
    idx = [torch.where((k >= 0) & (k < ns), k, ns) for k in keys]
    src = torch.ones(n, dtype=torch.int64, device=dev) if w is None \
        else w.to(torch.int64)
    out = torch.zeros(ns, dtype=torch.int64, device=dev)
    pad = torch.zeros(ns + 1, dtype=torch.int64, device=dev)
    k_it, i_it = itertools.cycle(keys), itertools.cycle(idx)
    t_kernel, e_kernel = cuda_time_ms(
        lambda: ck.onehot_dense_into(out, next(k_it), w), reps)
    t_plain, e_plain = cuda_time_ms(
        lambda: ck.onehot_dense_into_ref(out, next(k_it), w), reps)
    t_lib, e_lib = cuda_time_ms(
        lambda: pad.index_add_(0, next(i_it), src), reps)
    bound, bound_by = into_bound_ms(ns, n, fused.element_size(),
                                    w is not None)
    log('kernel onehot_dense_into %-24s %4d x %7d  exact  device ms: '
        'kernel %.4f plain %.4f index_add_ %.4f  (eager per call: %.4f '
        '%.4f %.4f)  bound %.6f ms (%s), %.1f %% of it'
        % (label, ns, n, t_kernel, t_plain, t_lib, e_kernel, e_plain,
           e_lib, bound, bound_by, 100 * bound / t_kernel))
    return {'keys': label, 'ns': ns, 'n': n, 'max_abs_err': err,
            'weighted': w is not None, 'key_bytes': fused.element_size(),
            'ms': t_kernel, 'plain_ms': t_plain, 'library_ms': t_lib,
            'bound_ms': bound, 'bound_by': bound_by,
            'bound_share': bound / t_kernel, 'eager_ms': e_kernel,
            'eager_plain_ms': e_plain, 'eager_library_ms': e_lib}


def check_kernel(ck, radices, n, unit_weights, reps, seed=1):
    """The codes entry (onehot_dense: fuse, zero-fill, kernel) against
    its plain version on the card at one shape, exactly, with its own
    times; then the kernel itself on the same fused key (check_into)."""
    import torch
    codes, w, alive = kernel_inputs(radices, n, seed, unit_weights)
    got = ck.onehot_dense(radices, codes, w, alive)
    want = ck.onehot_dense_ref(radices, codes, w, alive)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          'one-hot kernel differs from its plain version at %r x %d '
          '(max abs err %d)' % (radices, n, err))
    ns = got.shape[0]
    t_entry, e_entry = cuda_time_ms(
        lambda: ck.onehot_dense(radices, codes, w, alive), reps)
    bound, bound_by = kernel_bound_ms(radices, n, w is not None)
    log('entry onehot_dense %-14s x %6d  exact  device ms %.4f  eager '
        'per call %.4f  bound %.6f ms (%s)'
        % (str(tuple(radices)), n, t_entry, e_entry, bound, bound_by))
    from dragnet_tpu_torch.ops.kernels import fuse_keys
    fused = torch.where(alive, fuse_keys(radices, codes), ns).to(
        torch.int32)
    r = check_into(ck, 'codes %s' % (tuple(radices),), ns, fused, w,
                   reps)
    r.update({'radices': list(radices), 'entry_ms': t_entry,
              'eager_entry_ms': e_entry, 'entry_bound_ms': bound,
              'max_abs_err': max(err, r['max_abs_err'])})
    return r


def kernel_sweep(ck, reps):
    """Phase 2 beyond the reference's shapes: the main path's batch size
    over every segment count the gate allows, skewed and uniform; n = 0
    and 1; signed weights and i64 keys into a non-zero accumulator; and
    the 2,000,000-record call."""
    import numpy as np
    import torch
    results = []
    for ns in SWEEP_SEGMENTS:
        for kind in ('uniform', 'linear ts', 'one bin'):
            results.append(check_into(
                ck, kind, ns, fused_keys(kind, ns, BATCH_RECORDS), None,
                reps))
    for n in (0, 1):
        for ns in (SWEEP_SEGMENTS[0], SWEEP_SEGMENTS[-1]):
            results.append(check_into(
                ck, 'uniform', ns, fused_keys('uniform', ns, n), None,
                reps))
    rng = np.random.default_rng(4)
    ns = SWEEP_SEGMENTS[-1]
    out0 = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, ns)).to(DEVICE)
    w = torch.from_numpy(rng.integers(-3, 10, BATCH_RECORDS).astype(
        np.int32)).to(DEVICE)
    keys = torch.from_numpy(rng.integers(-5, ns + 5, BATCH_RECORDS)).to(
        DEVICE)
    results.append(check_into(ck, 'i64 signed, out != 0', ns, keys, w,
                              reps, out0=out0))
    results.append(check_into(ck, 'i32 signed, out != 0', ns,
                              keys.to(torch.int32), w, reps, out0=out0))
    large = fused_keys('uniform', LARGE_SEGMENTS, LARGE_RECORDS)
    copies = 1 + L2_BYTES // (4 * LARGE_RECORDS)
    results.append(check_into(ck, 'uniform, L2-cold', LARGE_SEGMENTS,
                              large, None, reps, copies=copies))
    results[-1]['floors'] = floors(large, copies, reps)
    del large
    torch.cuda.synchronize()
    return results


def floors(keys, copies, reps):
    """Device ms per call of two floors under the kernel's times: any
    launch (add_ on a 4,096-element i64 tensor), and a copy of the keys
    cycling over `copies` copies as check_into cycles them (out of L2),
    beside that copy's own bound."""
    import itertools
    import torch
    small = torch.zeros(4096, dtype=torch.int64, device=keys.device)
    t_launch, _ = cuda_time_ms(lambda: small.add_(1), reps)
    k_it = itertools.cycle([keys] + [keys.clone()
                                     for _ in range(copies - 1)])
    dst = torch.empty_like(keys)
    t_copy, _ = cuda_time_ms(lambda: dst.copy_(next(k_it)), reps)
    copy_bound = 2 * keys.numel() * keys.element_size() / \
        HBM_BYTES_PER_S * 1e3
    log('floors: a launch (add_ on 4,096 i64) %.4f ms; a copy of the %d '
        'L2-cold keys %.4f ms (its bound %.4f ms)'
        % (t_launch, keys.numel(), t_copy, copy_bound))
    return {'launch_ms': t_launch, 'copy_ms': t_copy,
            'copy_bound_ms': copy_bound}


def host_costs(ck, calls=2000):
    """The wrapper's stream lookup: the private raw handle it passes
    must equal torch.cuda.current_stream's, on the default stream and
    on a side stream; then the host ms per call of each lookup (host
    clock, `calls` calls)."""
    import torch
    dev = torch.device(DEVICE, torch.cuda.current_device())
    for s in (torch.cuda.current_stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(s):
            check(ck.current_stream_handle(dev.index) == s.cuda_stream ==
                  torch.cuda.current_stream(dev).cuda_stream,
                  'the raw stream handle differs from '
                  'torch.cuda.current_stream')
    times = {}
    for name, fn in (
            ('current_stream', lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            ('raw handle', lambda: ck.current_stream_handle(dev.index))):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times[name] = (time.perf_counter() - t0) / calls * 1e3
    log('stream lookup, host ms per call: torch.cuda.current_stream '
        '%.4f, raw handle %.4f (the same handle)'
        % (times['current_stream'], times['raw handle']))
    return times


def run_cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def host_output(cli, argv, ds):
    """The same CLI output, rendered from the port's host engine."""
    opts = cli.dn_parse_args(argv[1:], ['before', 'after', 'filter',
                                        'breakdowns', 'raw', 'points',
                                        'counters', 'gnuplot'])
    query = cli.dn_query_config(opts)
    result = ds.scan(query, engine='vector')
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.dn_output(query, opts, result, opts._args[0])
    return out.getvalue(), err.getvalue()


def main_path(cli, mod_ds, ck, ds, records):
    """Phase 4: the three scans through the CLI on DN_TORCH_DEVICE, with
    the batch and launch counts zeroed just before and read just after,
    then the same outputs from the host engine.  Returns the kernel
    shapes the main path used, a copy of the fused keys of each kernel
    query's largest batch at each segment count, and the launch
    count."""
    import torch
    # 4. the main path: counters zeroed just before, read just after
    batches = {'total': 0, 'device': 0}
    shapes = []
    captured = {}
    current = [None]
    orig_try = mod_ds.DeviceScan._try_device
    orig_kernel = ck.onehot_dense_into

    def try_device(self, provider, weights, alive):
        ok = orig_try(self, provider, weights, alive)
        batches['total'] += 1
        batches['device'] += int(ok)
        return ok

    def onehot_dense_into(out, fused, weights):
        ns, n = int(out.shape[0]), int(fused.shape[0])
        shapes.append((ns, n, weights is not None))
        best = captured.get((current[0], ns))
        if best is None or n > best[0].shape[0]:
            captured[(current[0], ns)] = (fused.clone(), weights)
        return orig_kernel(out, fused, weights)
    mod_ds.DeviceScan._try_device = try_device
    ck.onehot_dense_into = onehot_dense_into

    ck.reset_launches()
    per_query = []
    t_main = time.monotonic()
    for name, qargs, route in QUERIES:
        argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
        current[0] = name
        b0 = dict(batches)
        l0 = ck.launches['onehot_dense']
        s0 = len(shapes)
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, argv)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        check(rc == 0, '%s: scan failed: %s' % (name, err))
        nb = batches['total'] - b0['total']
        nd = batches['device'] - b0['device']
        nl = ck.launches['onehot_dense'] - l0
        segs = sorted(set(s[0] for s in shapes[s0:]))
        per_query.append((name, route, argv, out, err, dt, nb, nd, nl))
        log('scan %-36s %8.2f s  %11.0f records/s  batches %d '
            '(device %d)  kernel launches %d  kernel segments %s'
            % (name, dt, records / dt, nb, nd, nl, segs))
        check(nb > 0 and nd == nb,
              '%s: %d of %d batches ran on the device' % (name, nd, nb))
        if route == 'kernel':
            check(nl == nb, '%s: kernel launched %d times for %d '
                  'batches (segments %s)' % (name, nl, nb, segs))
        else:
            check(nl == 0, '%s: expected the scatter path, the kernel '
                  'launched %d times' % (name, nl))
    main_launches = ck.launches['onehot_dense']
    main_s = time.monotonic() - t_main
    mod_ds.DeviceScan._try_device = orig_try
    ck.onehot_dense_into = orig_kernel
    log('main path: %.2f s, one-hot kernel launches %d'
        % (main_s, main_launches))

    # the same outputs from the port's host engine
    for name, route, argv, out, err, dt, nb, nd, nl in per_query:
        t0 = time.monotonic()
        hout, herr = host_output(cli, argv, ds)
        ht = time.monotonic() - t0
        check(out == hout and err == herr,
              '%s: device output differs from the host engine' % name)
        check(out.count('\n') > 0 and 'Aggregator' in err,
              '%s: empty result' % name)
        log('host %-36s %8.2f s  %11.0f records/s  identical output '
            '(%d points)' % (name, ht, records / ht,
                             out.count('\n')))
    return shapes, captured, main_launches


class Spy(object):
    """Wraps attributes for the length of a phase and restores them."""

    def __init__(self):
        self.saved = []

    def wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self.saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved = []


class Timers(object):
    """Exclusive host-clock seconds per label over wrapped calls (a
    timed call inside another is taken out of the outer's time)."""

    def __init__(self):
        self.t = {}
        self._stack = []

    def wrap(self, spy, owner, name, label):
        def make(orig):
            def timed(*a, **k):
                t0 = time.perf_counter()
                self._stack.append(0.0)
                try:
                    return orig(*a, **k)
                finally:
                    inner = self._stack.pop()
                    dt = time.perf_counter() - t0
                    self.t[label] = self.t.get(label, 0.0) + dt - inner
                    if self._stack:
                        self._stack[-1] += dt
            return timed
        spy.wrap(owner, name, make)

    def take(self, total):
        """The seconds per label, the rest of `total` under 'rest',
        and reset."""
        out = dict(self.t)
        out['rest'] = total - sum(self.t.values())
        self.t = {}
        return out


def fmt_times(times, digits=2):
    return ', '.join('%s %.*f' % (k, digits, v) for k, v in sorted(
        times.items(), key=lambda kv: -kv[1]))


def sparse_fold_bench(mod_ds, reps):
    """The sparse fold alone on the card at each SPARSE_BENCH_CAPS
    capacity, the set as full as the guard lets it get (cap - n occupied
    slots) and one main-path batch of n keys already in the set (10 %
    dead), so repeated folds keep its size: device ms per fold (CUDA
    events over `reps` folds), and the ms of its sort (argsort of the
    occupied prefix plus the batch) alone."""
    import torch
    dev = torch.device(DEVICE)
    n = BATCH_RECORDS
    out = []
    g = torch.Generator(device=dev).manual_seed(5)
    for cap in SPARSE_BENCH_CAPS:
        occ = cap - n
        keys = torch.sort(torch.randperm(4 * cap, device=dev,
                                         generator=g)[:occ]).values
        acc = (torch.full((cap,), mod_ds.I64MAX, dtype=torch.int64,
                          device=dev),
               torch.zeros(cap, dtype=torch.int64, device=dev),
               torch.full((cap,), mod_ds.I64MAX, dtype=torch.int64,
                          device=dev),
               torch.zeros(8, dtype=torch.int64, device=dev),
               torch.zeros(2, dtype=torch.int64, device=dev))
        acc[0][:occ] = keys
        acc[1][:occ] = 1
        acc[2][:occ] = torch.arange(occ, device=dev)
        pick = torch.randint(0, occ, (n,), device=dev, generator=g)
        fused = keys[pick]
        dead = torch.rand(n, device=dev, generator=g) < 0.1
        fused[dead] = mod_ds.I64MAX
        wb = (~dead).to(torch.int64)
        first = torch.where(dead, mod_ds.I64MAX,
                            torch.arange(n, device=dev) + (1 << 32))
        cvec = torch.zeros(8, dtype=torch.int32, device=dev)
        state = [acc]

        def fold():
            state[0] = mod_ds.fold_sparse(state[0], cvec, fused, wb,
                                          first, occupied=occ)
        concat = torch.cat([keys, fused])
        t_fold, _ = cuda_time_events(fold, reps)
        t_sort, _ = cuda_time_events(lambda: torch.argsort(concat), reps)
        st = state[0][4].cpu().tolist()
        check(st == [occ, 0], 'sparse fold bench: the set changed size '
              '(%r, expected [%d, 0])' % (st, occ))
        nbytes = 8 * 3 * (occ + n) * 2
        log('sparse fold at %d slots (%d occupied + %d batch keys): '
            '%.4f ms per fold, its sort %.4f ms (%.0f %%); %.0f MB '
            'moved at least (%.4f ms at %.2f TB/s)'
            % (cap, occ, n, t_fold, t_sort, 100 * t_sort / t_fold,
               nbytes / 1e6, nbytes / HBM_BYTES_PER_S * 1e3,
               HBM_BYTES_PER_S / 1e12))
        out.append({'cap': cap, 'occupied': occ, 'n': n,
                    'fold_ms': t_fold, 'sort_ms': t_sort})
        del state, acc, keys, concat
    torch.cuda.synchronize()
    return out


def cuda_time_events(fn, reps):
    """(device ms, host ms) per call of fn, issued eagerly: CUDA events
    around `reps` calls after a warm-up (for work a CUDA graph cannot
    capture: host-side shape logic, in-place state)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(end) / reps, host


def without_spill(what, dev_err, host_err, sparse_rows):
    """The --counters dumps without the one counter the reference
    documents as differing (DeviceScan._build_static): the host engine
    spills a batch to its sort merge on its own per-batch decision,
    the device turns sparse on pow2 caps against 2^24.  The device's
    count is pinned exactly: every record its sparse batches
    aggregated (nothing is filtered out in these runs)."""
    spill = 'Aggregator         nspillrecords:%8d\n' % sum(sparse_rows)
    check(spill in dev_err, '%s: expected %r' % (what, spill))
    dev_err = dev_err.replace(spill, '', 1)
    check('nspillrecords' not in dev_err,
          '%s: a second spill count on the device' % what)
    host_err = ''.join(ln for ln in host_err.splitlines(True)
                       if 'nspillrecords' not in ln)
    return dev_err, host_err


def sparse_phase(cli, mod_ds, ds, records):
    """Phase 5: the SPARSE_QUERIES through the CLI on the card, counts
    zeroed just before each and read just after, each held to the host
    engine's output."""
    import torch
    from dragnet_tpu_torch import datasource_file as mod_dsf
    spy = Spy()
    batches = {'total': 0, 'device': 0}
    routes = []
    sparse_rows = []
    folds = []
    caps = []

    def wrap_try(orig):
        def try_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            batches['total'] += 1
            batches['device'] += int(ok)
            return ok
        return try_device

    def wrap_fold(orig):
        def fold(self, *a):
            routes.append('dense')
            return orig(self, *a)
        return fold

    def wrap_fold_sparse(orig):
        def fold_sparse(self, args, n, profile, caps_, occupied, base):
            routes.append('sparse')
            sparse_rows.append(n)
            return orig(self, args, n, profile, caps_, occupied, base)
        return fold_sparse

    def wrap_program(orig):
        def timed(acc, cvec, fused, wb, first_b, occupied=None):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig(acc, cvec, fused, wb, first_b, occupied=occupied)
            e.record()
            folds.append((s, e, int(acc[0].shape[0]),
                          int(fused.shape[0]) + (occupied or 0)))
            return out
        return timed

    def wrap_guard(orig):
        def guard(self, n):
            ok = orig(self, n)
            caps.append(self._sparse_cap)
            return ok
        return guard

    def wrap_scan(orig):
        def scan(self, *a, **k):
            t0 = time.monotonic()
            rv = orig(self, *a, **k)
            scan_times.append(time.monotonic() - t0)
            return rv
        return scan
    scan_times = []
    spy.wrap(mod_dsf.DatasourceFile, 'scan', wrap_scan)
    # where a scan's host time goes (the device work surfaces where the
    # host waits for it: in uploads behind queued folds, and the flush)
    from dragnet_tpu_torch import engine as mod_engine
    timers = Timers()
    for owner, name, label in (
            (mod_ds.DeviceScan, '_stage_device', 'stage'),
            (mod_ds.DeviceScan, '_upload_inputs', 'upload'),
            (mod_ds.DeviceScan, '_fold_staged', 'fold submit'),
            (mod_ds.DeviceScan, '_flush', 'flush fetch'),
            (mod_engine.VectorScan, '_emit_unique', 'emit'),
            (mod_engine.VectorScan, '_defer_compact', 'deferred merge'),
            (mod_engine.VectorScan, '_defer_final', 'deferred merge'),
            (mod_engine.VectorScan, '_process', 'host engine batch')):
        timers.wrap(spy, owner, name, label)
    spy.wrap(mod_ds.DeviceScan, '_try_device', wrap_try)
    spy.wrap(mod_ds.DeviceScan, '_fold', wrap_fold)
    spy.wrap(mod_ds.DeviceScan, '_fold_sparse', wrap_fold_sparse)
    spy.wrap(mod_ds, 'fold_sparse', wrap_program)
    spy.wrap(mod_ds.DeviceScan, '_sparse_guard', wrap_guard)
    out = []
    try:
        for name, qargs, expect in SPARSE_QUERIES:
            argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
            batches.update(total=0, device=0)
            del routes[:], sparse_rows[:], folds[:], caps[:]
            mod_ds.sparse_folds['fold_sparse'] = 0
            t0 = time.monotonic()
            rc, sout, serr = run_cli(cli, argv)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            dev_times = timers.take(scan_times[-1])
            nfolds = mod_ds.sparse_folds['fold_sparse']
            check(rc == 0, '%s: scan failed: %s' % (name, serr))
            nb, nd = batches['total'], batches['device']
            check(nb > 0 and nd == nb, '%s: %d of %d batches ran on the '
                  'device' % (name, nd, nb))
            check(nfolds == routes.count('sparse') > 0 and
                  len(routes) == nb,
                  '%s: sparse fold ran %d times, routes %r'
                  % (name, nfolds, routes))
            if expect == 'dense then sparse':
                check(routes[0] == 'dense' and routes == sorted(routes),
                      '%s: expected dense batches, then sparse: %r'
                      % (name, routes))
            else:
                check(set(routes) == {'sparse'} and
                      max(caps) > mod_ds.SPARSE_CAP0,
                      '%s: expected every batch sparse and the set to '
                      'grow past %d: routes %r, capacities %r'
                      % (name, mod_ds.SPARSE_CAP0, routes, sorted(set(caps))))
            fold_ms = [s.elapsed_time(e) for s, e, _, _ in folds]
            by_cap = {}
            for (s, e, cap, nsort), ms in zip(folds, fold_ms):
                by_cap.setdefault(cap, []).append((ms, nsort))
            t0 = time.monotonic()
            hout, herr = host_output(cli, argv, ds)
            ht = time.monotonic() - t0
            scan_s, hscan_s = scan_times[-2:]
            host_times = timers.take(hscan_s)
            if expect == 'dense then sparse':
                serr, herr = without_spill(name, serr, herr, sparse_rows)
            check(sout == hout and serr == herr,
                  '%s: device output differs from the host engine' % name)
            npoints = sout.count('\n')
            log('sparse %-40s device %7.2f s %10.0f records/s (scan '
                '%.2f s, %.0f records/s) | host %7.2f s %10.0f records/s '
                '(scan %.2f s, %.0f records/s) | identical (%d points) | '
                'batches %d (dense %d, sparse %d) | capacity reached %d'
                % (name, dt, records / dt, scan_s, records / scan_s, ht,
                   records / ht, hscan_s, records / hscan_s, npoints, nb,
                   routes.count('dense'), nfolds, max(caps or [0])))
            log('    scan host s, device: %s | host engine: %s'
                % (fmt_times(dev_times), fmt_times(host_times)))
            for cap, v in sorted(by_cap.items()):
                ms = [m for m, _ in v]
                log('    fold at %d slots: %d folds, device ms per fold '
                    'mean %.4f min %.4f max %.4f, keys sorted per fold '
                    '%d-%d' % (cap, len(ms), sum(ms) / len(ms), min(ms),
                               max(ms), min(k for _, k in v),
                               max(k for _, k in v)))
            out.append({'query': name, 'device_s': dt, 'host_s': ht,
                        'device_scan_s': scan_s, 'host_scan_s': hscan_s,
                        'device_times': dev_times,
                        'host_times': host_times,
                        'batches': nb, 'sparse_folds': nfolds,
                        'dense_batches': routes.count('dense'),
                        'capacity': max(caps or [0]), 'points': npoints,
                        'fold_ms_by_cap': {
                            str(c): [m for m, _ in v]
                            for c, v in by_cap.items()}})
    finally:
        spy.restore()
    return out


def tree_files(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def build_phase(cli, mod_ds, ck, tmp, data, records):
    """Phase 6: BUILD_METRICS built on the card through the CLI (counts
    zeroed just before, read just after) and with the host engine, then
    index-scan on both; trees and outputs held byte for byte."""
    import torch
    from dragnet_tpu_torch import config as mod_config
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import datasource_for_name, metrics_for_index
    from dragnet_tpu_torch import index_build_mt as mod_ibmt
    from dragnet_tpu_torch import native_index
    dev_idx = os.path.join(tmp, 'idx_device')
    host_idx = os.path.join(tmp, 'idx_host')
    rc, _, err = run_cli(cli, [
        'datasource-add', 'idx', '--path=' + data, '--time-field=time',
        '--index-path=' + dev_idx])
    check(rc == 0, 'datasource-add failed: %s' % err)
    for metric, breakdowns, route in BUILD_METRICS:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns, 'idx',
                                   metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    rc, mlist, err = run_cli(cli, ['metric-list', 'idx'])
    check(rc == 0 and all(m in mlist for m, _, _ in BUILD_METRICS),
          'metric-list: %s %s' % (mlist, err))
    # the DNC writer's library builds on first use: build it before the
    # timed builds, so neither engine's writer time includes g++
    t0 = time.monotonic()
    dnc = native_index.get_lib() is not None
    log('libdnindex.so %s (%.2f s, before the timed builds)'
        % ('loaded' if dnc else 'NOT loaded: the numpy writer runs',
           time.monotonic() - t0))

    spy = Spy()
    stack = {'batches': 0, 'stacked': 0}
    routes = {}
    sparse_rows = []
    writes = []

    def wrap_process(orig):
        def process(self, provider, weights, alive):
            stack['batches'] += 1
            return orig(self, provider, weights, alive)
        return process

    def wrap_device(orig):
        def process_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            stack['stacked'] += int(ok)
            return ok
        return process_device

    def wrap_fold(orig):
        def fold(self, args, n, profile, caps, ns, use_kernel, base):
            routes.setdefault(self._pfx, []).append(
                'kernel' if use_kernel else 'index_add')
            return orig(self, args, n, profile, caps, ns, use_kernel, base)
        return fold

    def wrap_fold_sparse(orig):
        def fold_sparse(self, args, n, *a):
            routes.setdefault(self._pfx, []).append('sparse')
            sparse_rows.append(n)
            return orig(self, args, n, *a)
        return fold_sparse

    def wrap_write(orig):
        def write(*a, **k):
            t0 = time.monotonic()
            rv = orig(*a, **k)
            writes.append(time.monotonic() - t0)
            return rv
        return write
    spy.wrap(mod_ds.DeviceScanStack, 'process', wrap_process)
    spy.wrap(mod_ds.DeviceScanStack, '_process_device', wrap_device)
    spy.wrap(mod_ds.DeviceScan, '_fold', wrap_fold)
    spy.wrap(mod_ds.DeviceScan, '_fold_sparse', wrap_fold_sparse)
    spy.wrap(mod_ibmt, 'write_index_blocks', wrap_write)
    from dragnet_tpu_torch import engine as mod_engine
    timers = Timers()
    for owner, name, label in (
            (mod_ds.DeviceScanStack, 'process', 'stack stage + fold'),
            (mod_ds.DeviceScan, '_flush', 'flush fetch'),
            (mod_engine.VectorScan, '_emit_unique', 'emit'),
            (mod_engine.VectorScan, '_defer_compact', 'deferred merge'),
            (mod_engine.VectorScan, '_defer_final', 'deferred merge'),
            (mod_engine.VectorScan, '_process', 'host engine batch'),
            (mod_ibmt, '_publish_buckets', 'index write + publish')):
        timers.wrap(spy, owner, name, label)
    try:
        # the build path: counts zeroed just before, read just after
        ck.reset_launches()
        t0 = time.monotonic()
        rc, bout, berr = run_cli(cli, ['build', '--interval=hour',
                                       '--counters', 'idx'])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        build_launches = ck.launches['onehot_dense']
        dev_times = timers.take(dt)
        check(rc == 0, 'build failed: %s' % berr)
        dev_write = writes[-1]
        nb, ns_ = stack['batches'], stack['stacked']
        check(nb > 0 and ns_ == nb, 'build: %d of %d batches went through '
              'the stacked fold' % (ns_, nb))
        for i, (metric, _, route) in enumerate(BUILD_METRICS):
            got = routes.get('m%d_' % i, [])
            check(len(got) == nb and route in got and
                  (route != 'kernel' or set(got) == {'kernel'}),
                  'build: %s expected the %s route, got %r'
                  % (metric, route, sorted(set(got))))
            log('build metric %-9s folds %d, routes %s'
                % (metric, len(got),
                   ', '.join('%s %d' % (r, got.count(r))
                             for r in ('kernel', 'index_add', 'sparse')
                             if r in got)))
        check(build_launches == nb,
              'build: the one-hot kernel launched %d times for %d stacked '
              'batches' % (build_launches, nb))

        # the host engine into a second tree
        _, config = mod_config.ConfigBackendLocal().load()
        dsconfig = dict(config.datasource_get('idx'))
        bc = dict(dsconfig['ds_backend_config'], indexPath=host_idx)
        dsconfig['ds_backend_config'] = bc
        hds = mod_dsf.DatasourceFile(dsconfig)
        metrics = metrics_for_index(config, 'idx')
        t0 = time.monotonic()
        hres = hds.build(metrics, 'hour', engine='vector')
        ht = time.monotonic() - t0
        host_times = timers.take(ht)
        host_write = writes[-1]
    finally:
        spy.restore()
    herr = io.StringIO()
    herr.write('indexes for "idx" built\n')
    hres.pipeline.dump_counters(herr)
    berr, herr = without_spill('build', berr, herr.getvalue(), sparse_rows)
    check(berr == herr, 'build --counters differs from the host engine:'
          '\n%s\n%s' % (berr, herr))
    dtree, htree = tree_files(dev_idx), tree_files(host_idx)
    check(dtree.keys() == htree.keys() and
          all(dtree[k] == htree[k] for k in dtree),
          'build: the device tree differs from the host engine\'s: %r'
          % sorted(k for k in set(dtree) | set(htree)
                   if dtree.get(k) != htree.get(k)))
    shards = [k for k in dtree if k.endswith('.sqlite')]
    check(len(shards) >= 3 and '.dn_integrity.json' in dtree,
          'build: shards %r' % sorted(dtree))
    nbytes = sum(len(dtree[k]) for k in shards)
    log('build device %7.2f s %10.0f records/s (index write + publish '
        '%.2f s) | host %7.2f s %10.0f records/s (write %.2f s) | trees '
        'identical: %d shards, %d bytes, + integrity catalog | '
        'libdnindex.so %s | stacked batches %d, kernel launches %d'
        % (dt, records / dt, dev_write, ht, records / ht, host_write,
           len(shards), nbytes, 'loaded' if dnc else 'NOT loaded (numpy '
           'writer)', nb, build_launches))

    log('    build host s, device: %s | host engine: %s'
        % (fmt_times(dev_times), fmt_times(host_times)))

    # index-scan on both engines
    t0 = time.monotonic()
    rc, sout, serr = run_cli(cli, ['index-scan', '--interval=hour', 'idx'])
    torch.cuda.synchronize()
    st = time.monotonic() - t0
    check(rc == 0, 'index-scan failed: %s' % serr)
    ds = datasource_for_name(config, 'idx')
    t0 = time.monotonic()
    res = ds.index_scan(metrics, 'hour', engine='vector')
    opts = cli.dn_parse_args(['idx'], ['counters'])
    opts.points = True
    hout, herr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(hout), contextlib.redirect_stderr(herr):
        cli.dn_output(None, opts, res, 'idx')
    hst = time.monotonic() - t0
    check(sout == hout.getvalue() and sout.count('\n') > 0,
          'index-scan differs from the host engine')
    log('index-scan device %.2f s | host %.2f s (each with its output) | '
        'identical (%d points)' % (st, hst, sout.count('\n')))
    return {'device_s': dt, 'host_s': ht, 'device_times': dev_times,
            'host_times': host_times, 'device_write_s': dev_write,
            'host_write_s': host_write, 'batches': nb, 'stacked': ns_,
            'build_launches': build_launches, 'shards': len(shards),
            'shard_bytes': nbytes, 'libdnindex': dnc,
            'index_scan_device_s': st, 'index_scan_host_s': hst,
            'routes': {m: sorted(set(routes.get('m%d_' % i, [])))
                       for i, (m, _, _) in enumerate(BUILD_METRICS)}}


class FoldTimer(object):
    """CUDA events around each call of device_index._fold_program, and
    the host-side sizes of the work K7 must do (rows, translation
    entries, accumulator segments)."""

    def __init__(self, spy, mod_di):
        import torch
        self.events = []
        self.rows = self.tab = self.segs = 0

        def wrap_fold(orig):
            def fold(lmat, wmat, ttabs, acc):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rv = orig(lmat, wmat, ttabs, acc)
                e1.record()
                self.events.append((e0, e1))
                return rv
            return fold

        def wrap_stage(orig):
            def stage(inv_sl):
                local, ttable, nlocal = orig(inv_sl)
                self.rows += len(local)
                self.tab += nlocal
                return local, ttable, nlocal
            return stage

        def wrap_batched(orig):
            def batched(inv, weights, nuniq, **k):
                rv = orig(inv, weights, nuniq, **k)
                if rv is not None:
                    self.segs += nuniq
                return rv
            return batched
        spy.wrap(mod_di, '_fold_program', wrap_fold)
        spy.wrap(mod_di, '_stage_shard', wrap_stage)
        spy.wrap(mod_di, 'batched_sums', wrap_batched)

    def take(self):
        """(device ms per dispatch list, bound ms) since the last take."""
        import torch
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        nbytes = (self.rows * K7_ROW_BYTES + self.tab * K7_TAB_BYTES +
                  self.segs * K7_SEG_BYTES)
        self.events = []
        self.rows = self.tab = self.segs = 0
        return ms, nbytes / HBM_BYTES_PER_S * 1e3


def query_phase(cli, ck, tmp, records, seed):
    """Phase 7: `dn query` over index trees built on the card, each of
    QUERY_CASES through the CLI on the card (the K1 launch count and
    the fold's engagement zeroed just before the queries, read just
    after) and with the port's host engine on the same tree."""
    import torch
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch import device_index as mod_di
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import index_query_mt as mod_iqmt
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    from dragnet_tpu_torch.config import ConfigBackendLocal
    from dragnet_tpu_torch import datasource_for_name
    data = os.path.join(tmp, 'month.log')
    t0 = time.monotonic()
    mod_native.gen_to_file(records, data, mindate_ms=QUERY_MIN_MS,
                           maxdate_ms=QUERY_MIN_MS + QUERY_DAYS * 86400000,
                           seed=seed)
    log('query data: %d records over %d days (%d bytes) in %.2f s'
        % (records, QUERY_DAYS, os.path.getsize(data),
           time.monotonic() - t0))
    rc, _, err = run_cli(cli, [
        'datasource-add', 'month', '--path=' + data, '--time-field=time',
        '--index-path=' + os.path.join(tmp, 'idx_month')])
    check(rc == 0, 'datasource-add failed: %s' % err)
    for metric, breakdowns, _route in BUILD_METRICS:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns,
                                   'month', metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    builds = {}
    for interval in ('hour', 'day'):
        t0 = time.monotonic()
        rc, _, err = run_cli(cli, ['build', '--interval=' + interval,
                                   'month'])
        torch.cuda.synchronize()
        builds[interval] = time.monotonic() - t0
        check(rc == 0, 'build --interval=%s failed: %s' % (interval, err))
        shards = os.listdir(os.path.join(tmp, 'idx_month',
                                         'by_' + interval))
        log('query tree: build --interval=%s on the card %.2f s, %d '
            'shards' % (interval, builds[interval],
                        len([s for s in shards if s.endswith('.sqlite')])))
    _, config = ConfigBackendLocal().load()
    ds = datasource_for_name(config, 'month')

    spy = Spy()
    results = []
    captured = []
    stages = {}

    def wrap_query(orig):
        def query(self, *a, **k):
            rv = orig(self, *a, **k)
            captured.append(rv)
            return rv
        return query

    def wrap_timed(orig):
        @contextlib.contextmanager
        def timed_stage(name, *a, **k):
            t0 = time.perf_counter()
            try:
                with orig(name, *a, **k) as sp:
                    yield sp
            finally:
                stages[name] = stages.get(name, 0.0) + \
                    time.perf_counter() - t0
        return timed_stage
    spy.wrap(mod_dsf.DatasourceFile, 'query', wrap_query)
    spy.wrap(obs_metrics, 'timed_stage', wrap_timed)
    folds = FoldTimer(spy, mod_di)
    timers = Timers()
    for owner, name, label in (
            (mod_di, '_stage_shard', 'staging'),
            (mod_di, '_pad_slot', 'staging'),
            (mod_di, '_fold_program', 'fold submit'),
            (mod_di, '_device_fold', 'pack + upload + fetch')):
        timers.wrap(spy, owner, name, label)
    try:
        # the query path: counts zeroed just before, read just after
        ck.reset_launches()
        mod_di._reset_engagement()
        for name, qargs, route in QUERY_CASES:
            argv = ['query', '--points', '--counters'] + qargs + ['month']
            mod_iqmt.shard_cache_clear()
            runs = []
            for attempt in range(2):
                e0 = mod_di.stats_doc()
                stages.clear()
                timers.take(0.0)
                t0 = time.monotonic()
                rc, out, err = run_cli(cli, argv)
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
                check(rc == 0, '%s: query failed: %s' % (name, err))
                e1 = mod_di.stats_doc()
                fold_ms, bound_ms = folds.take()
                runs.append({
                    'wall_s': dt, 'out': out, 'err': err,
                    'dispatches': e1['dispatches'] - e0['dispatches'],
                    'h2d_bytes': e1['h2d_bytes'] - e0['h2d_bytes'],
                    'rows': e1['rows'] - e0['rows'],
                    'routes': {r: n - e0['routes'].get(r, 0)
                               for r, n in e1['routes'].items()
                               if n != e0['routes'].get(r, 0)},
                    'fold_ms': fold_ms, 'bound_ms': bound_ms,
                    'stages': dict(stages),
                    'device_times': timers.take(0.0),
                    'index_list': dict(
                        [s for s in captured[-1].pipeline.stages
                         if s.name == 'Index List'][0].counters)})
            # the host engine on the same tree, the same rendering
            opts = cli.dn_parse_args(argv[1:], [
                'before', 'after', 'filter', 'breakdowns', 'raw',
                'points', 'counters', 'interval', 'gnuplot', 'dry-run'])
            query = cli.dn_query_config(opts)
            stages.clear()
            t0 = time.monotonic()
            hres = ds.query(query, opts.interval, engine='vector')
            hout, herr = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(hout), \
                    contextlib.redirect_stderr(herr):
                cli.dn_output(query, opts, hres, 'month')
            ht = time.monotonic() - t0
            host_stages = dict(stages)
            for r in runs:
                check(r['out'] == hout.getvalue() and
                      r['err'] == herr.getvalue(),
                      '%s: device output differs from the host engine'
                      % name)
                check(r['routes'] == {route: 1},
                      '%s: expected the route %r, got %r'
                      % (name, route, r['routes']))
                il = r['index_list']
                if route == 'device':
                    check(il.get('index device sums') == 1 and
                          r['dispatches'] > 0,
                          '%s: the device fold did not run: %r, %d '
                          'dispatches' % (name, il, r['dispatches']))
                else:
                    check('index device sums' not in il and
                          r['dispatches'] == 0,
                          '%s: the host route engaged the device' % name)
            check(hout.getvalue().count('\n') > 0 and
                  'Index List' in herr.getvalue(),
                  '%s: empty result' % name)
            il = runs[0]['index_list']
            if '--after' in qargs:
                check(il.get('index shards pruned', 0) > 0,
                      '%s: no shard pruned: %r' % (name, il))
            npoints = hout.getvalue().count('\n')
            r = runs[1]
            fold_ms = r['fold_ms']
            log('query %-33s device %.3f s (first %.3f s) | host %.3f s '
                '| identical, %d points | %d index rows, shards queried '
                '%d pruned %d | route %s'
                % (name, r['wall_s'], runs[0]['wall_s'], ht, npoints,
                   r['rows'], il.get('index shards queried', 0),
                   il.get('index shards pruned', 0), route))
            if fold_ms:
                log('    K7 fold: %d dispatches, device ms per dispatch '
                    '%.4f (min %.4f, max %.4f, total %.3f), bound %.4f '
                    'ms, H2D %d bytes'
                    % (len(fold_ms), sum(fold_ms) / len(fold_ms),
                       min(fold_ms), max(fold_ms), sum(fold_ms),
                       r['bound_ms'], r['h2d_bytes']))
            log('    host s: %s | inside aggregate: %s | host engine: %s'
                % (fmt_times(r['stages'], 4),
                   fmt_times({k: v for k, v in r['device_times'].items()
                              if k != 'rest'}, 4),
                   fmt_times(host_stages, 4)))
            results.append({
                'name': name, 'args': qargs, 'route': route,
                'points': npoints, 'host_s': ht,
                'device_s': [x['wall_s'] for x in runs],
                'dispatches': r['dispatches'], 'rows': r['rows'],
                'h2d_bytes': r['h2d_bytes'], 'fold_ms': fold_ms,
                'bound_ms': r['bound_ms'], 'stages': r['stages'],
                'host_stages': host_stages,
                'aggregate_parts': r['device_times'],
                'shards_queried': il.get('index shards queried', 0),
                'shards_pruned': il.get('index shards pruned', 0)})
        query_launches = ck.launches['onehot_dense']
    finally:
        spy.restore()
    return {'builds_s': builds, 'queries': results,
            'onehot_launches': query_launches}


def main_path_keys(ck, captured, reps):
    """Phase 5: the kernel on the fused keys the main path gave it, the
    largest batch of each query at each segment count."""
    import torch
    results = []
    for (name, ns), (fused, w) in sorted(captured.items()):
        results.append(check_into(ck, 'main path: %s' % name, ns, fused,
                                  w, reps))
        results[-1]['query'] = name
    torch.cuda.synchronize()
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--records', type=int, default=2000000)
    ap.add_argument('--seed', type=int, default=12345)
    ap.add_argument('--reps', type=int, default=100)
    ap.add_argument('--json', help='also write every kernel shape\'s '
                    'result to this file')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: CUDA is not available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from dragnet_tpu_torch import cli
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch import device_scan as mod_ds
    from dragnet_tpu_torch.config import ConfigBackendLocal
    from dragnet_tpu_torch import datasource_for_name
    from dragnet_tpu_torch.ops import cuda_kernels as ck

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log('card: %s (torch %s, CUDA %s)' % (card, torch.__version__,
                                          torch.version.cuda))

    # 1. build
    t0 = time.monotonic()
    nvcc_log = ck.build()
    ck._load()
    log('build: onehot_agg.cu in %.2f s' % (time.monotonic() - t0))
    log(nvcc_log.rstrip() if nvcc_log else
        '(library up to date, not rebuilt)')

    # 2. kernel vs plain at the reference's test shapes (weighted), at
    # one batch with each kernel query's caps (unit weights, as the main
    # path calls it), and over the sweep
    results = [check_kernel(ck, radices, n, False, args.reps)
               for radices, n in PALLAS_SHAPES]
    slice_results = [check_kernel(ck, radices, n, True, args.reps)
                     for radices, n in SLICE_SHAPES]
    sweep_results = kernel_sweep(ck, args.reps)
    stream_costs = host_costs(ck)
    fold_bench = sparse_fold_bench(mod_ds, args.reps)
    torch.cuda.synchronize()

    # 3. data
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        data = os.path.join(tmp, 'muskie.log')
        t0 = time.monotonic()
        mod_native.gen_to_file(args.records, data, seed=args.seed)
        log('data: %d records (%d bytes) in %.2f s'
            % (args.records, os.path.getsize(data),
               time.monotonic() - t0))
        os.environ['DRAGNET_CONFIG'] = os.path.join(tmp, 'dragnetrc')
        os.environ['DN_TORCH_DEVICE'] = DEVICE
        rc, out, err = run_cli(cli, [
            'datasource-add', 'muskie', '--path=' + data,
            '--time-field=time', '--filter={"ne":["host","zzz"]}'])
        check(rc == 0, 'datasource-add failed: %s' % err)
        _, config = ConfigBackendLocal().load()
        ds = datasource_for_name(config, 'muskie')
        cold = os.path.join(tmp, 'cold.log')
        mod_native.gen_to_file(COLD_RECORDS, cold, seed=args.seed + 1)
        rc, out, err = run_cli(cli, [
            'datasource-add', 'cold', '--path=' + cold,
            '--time-field=time', '--filter={"ne":["host","zzz"]}'])
        check(rc == 0, 'datasource-add failed: %s' % err)
        for name, qargs, route in QUERIES:
            t0 = time.monotonic()
            rc, out, err = run_cli(cli, ['scan'] + qargs + ['cold'])
            torch.cuda.synchronize()
            check(rc == 0, 'cold %s: scan failed: %s' % (name, err))
            log('cold %-36s %8.3f s  (%d records, first scans of the '
                'process)' % (name, time.monotonic() - t0, COLD_RECORDS))

        shapes, captured, main_launches = main_path(cli, mod_ds, ck, ds,
                                                    args.records)
        sparse = sparse_phase(cli, mod_ds, ds, args.records)
        build = build_phase(cli, mod_ds, ck, tmp, data, args.records)
        queries = query_phase(cli, ck, tmp, args.records, args.seed)
    torch.cuda.synchronize()

    # 5. the kernel on the main path's own keys, and on uniform keys at
    # the largest batch of each accumulator shape it gave the kernel
    largest = {}
    for ns, n, weighted in shapes:
        key = (ns, weighted)
        largest[key] = max(largest.get(key, 0), n)
    log('main path kernel shapes (segments, weighted: largest batch): %s'
        % sorted(largest.items()))
    main_results = main_path_keys(ck, captured, args.reps)
    check(len(main_results) >= 2, 'no main-path keys were captured')
    results += slice_results + sweep_results + main_results
    results += [check_into(ck, 'uniform', ns,
                           fused_keys('uniform', ns, n), None, args.reps)
                for (ns, weighted), n in sorted(largest.items())]
    torch.cuda.synchronize()

    at_batch = [r for r in sweep_results + main_results
                if r['n'] == BATCH_RECORDS or r['keys'].startswith('main')]
    for weighted in (False, True):
        timed = [r for r in at_batch if r['weighted'] == weighted]
        slower = [(r['keys'], r['ns'], r['ms'], r['library_ms'])
                  for r in timed if r['ms'] > r['library_ms']]
        log('kernel vs index_add_ at the main path\'s batch, %s weights '
            '(%d shapes): %s' % ('signed' if weighted else 'unit',
                                 len(timed), 'never slower' if not slower
                                 else 'slower at %r' % slower))
    main = [r for r in main_results if r['query'] == QUERIES[1][0]][0]
    large = [r for r in sweep_results if r['n'] == LARGE_RECORDS][0]
    log('bound share at %d x %d: %.1f %% (%.4f ms for a bound of %.4f ms)'
        % (LARGE_RECORDS, LARGE_SEGMENTS, 100 * large['bound_share'],
           large['ms'], large['bound_ms']))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump({'card': card, 'stream_lookup_ms': stream_costs,
                       'shapes': results, 'sparse_fold_bench': fold_bench,
                       'sparse_scans': sparse, 'build': build,
                       'query': queries}, f,
                      indent=1)
    print(json.dumps({'query': [
        {k: q[k] for k in ('name', 'route', 'points', 'device_s',
                           'host_s', 'dispatches', 'rows', 'h2d_bytes',
                           'bound_ms', 'stages')} for q in
        queries['queries']], 'builds_s': queries['builds_s']}),
        flush=True)
    log('gpu: %s' % card)
    print(json.dumps({'kernels': [{
        'name': 'onehot_dense', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': KERNEL_REPLACES, 'launches': main_launches,
        'build_launches': build['build_launches'],
        'query_launches': queries['onehot_launches'],
        'max_abs_err': max(r['max_abs_err'] for r in results),
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'library_ms': main['library_ms'], 'eager_ms': main['eager_ms'],
        'shape': {'keys': main['keys'], 'ns': main['ns'],
                  'n': main['n']},
        'shapes': results}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
