#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--records N] [--seed S] [--reps R]

Phases, each ending in torch.cuda.synchronize() so a fault shows where
it happened; any failed check exits non-zero:

1. build   the one-hot aggregation kernel (ops/csrc/onehot_agg.cu) from
           the sources in this checkout, with nvcc.
2. kernel  the kernel against its plain torch version, exactly, at the
           four shapes of tests/test_pallas.py and at one batch (65,536
           records) with each kernel query's caps; prints the kernel's,
           the plain version's and torch's index_add_ times.
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
5. result  the card's name and power limit (nvidia-smi), a `kernels`
           JSON line (launches on the main path, times, bound), and as
           the last line {"ok": true, "device": {...}}.

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

KERNEL_SOURCE = 'dragnet_tpu_torch/ops/csrc/onehot_agg.cu'
KERNEL_REPLACES = 'dragnet_tpu/ops/pallas_kernels.py:102'

PALLAS_SHAPES = [((8, 64), 1000), ((3, 5, 7), 4096), ((513,), 700),
                 ((8, 16, 32), 8192)]
COLD_RECORDS = 20000

# one batch with each kernel query's staged caps, unit weights (as the
# main path calls it); the first is the shape the kernels line reports
SLICE_SHAPES = [((8, 32), 65536), ((256, 16), 65536)]

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
    dev = torch.device('cuda')
    return (torch.from_numpy(codes).to(dev),
            None if w is None else torch.from_numpy(w).to(dev),
            torch.from_numpy(alive).to(dev))


def kernel_bound_ms(radices, n, weighted):
    """Least time for the function: its bytes (codes, weights, alive
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


def check_kernel(ck, radices, n, unit_weights, reps, seed=1):
    """Kernel vs plain version on the card at one shape: exact equality,
    then times of the kernel, the plain version and index_add_."""
    import torch
    from dragnet_tpu_torch.ops.kernels import fuse_keys
    codes, w, alive = kernel_inputs(radices, n, seed, unit_weights)
    got = ck.onehot_dense(radices, codes, w, alive)
    want = ck.onehot_dense_ref(radices, codes, w, alive)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          'one-hot kernel differs from its plain version at %r x %d '
          '(max abs err %d)' % (radices, n, err))
    ns = got.shape[0]
    fused = fuse_keys(radices, codes)
    wl = alive.to(torch.int64) if w is None else \
        torch.where(alive, w, 0).to(torch.int64)
    t_kernel, e_kernel = cuda_time_ms(
        lambda: ck.onehot_dense(radices, codes, w, alive), reps)
    t_plain, e_plain = cuda_time_ms(
        lambda: ck.onehot_dense_ref(radices, codes, w, alive), reps)
    t_lib, e_lib = cuda_time_ms(lambda: torch.zeros(
        ns, dtype=torch.int64, device=codes.device).index_add_(
            0, fused, wl), reps)
    bound, bound_by = kernel_bound_ms(radices, n, w is not None)
    log('kernel onehot_dense %-14s x %6d  exact  device ms: kernel %.4f '
        'plain %.4f index_add_ %.4f  (eager per call: %.4f %.4f %.4f)  '
        'bound %.6f ms (%s)'
        % (str(tuple(radices)), n, t_kernel, t_plain, t_lib, e_kernel,
           e_plain, e_lib, bound, bound_by))
    return {'radices': list(radices), 'n': n, 'max_abs_err': err,
            'ms': t_kernel, 'plain_ms': t_plain, 'library_ms': t_lib,
            'bound_ms': bound, 'bound_by': bound_by,
            'eager_ms': e_kernel, 'eager_plain_ms': e_plain,
            'eager_library_ms': e_lib}


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
    shapes the main path used and its launch count."""
    import torch
    # 4. the main path: counters zeroed just before, read just after
    batches = {'total': 0, 'device': 0}
    shapes = []
    orig_try = mod_ds.DeviceScan._try_device
    orig_kernel = ck.onehot_dense

    def try_device(self, provider, weights, alive):
        ok = orig_try(self, provider, weights, alive)
        batches['total'] += 1
        batches['device'] += int(ok)
        return ok

    def onehot_dense(radices, codes, weights, alive):
        shapes.append((tuple(radices), int(codes.shape[1]),
                       weights is not None))
        return orig_kernel(radices, codes, weights, alive)
    mod_ds.DeviceScan._try_device = try_device
    ck.onehot_dense = onehot_dense

    ck.reset_launches()
    per_query = []
    t_main = time.monotonic()
    for name, qargs, route in QUERIES:
        argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
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
        caps = sorted(set(s[0] for s in shapes[s0:]))
        per_query.append((name, route, argv, out, err, dt, nb, nd, nl))
        log('scan %-36s %8.2f s  %11.0f records/s  batches %d '
            '(device %d)  kernel launches %d  kernel caps %s'
            % (name, dt, records / dt, nb, nd, nl, caps))
        check(nb > 0 and nd == nb,
              '%s: %d of %d batches ran on the device' % (name, nd, nb))
        if route == 'kernel':
            check(nl == nb, '%s: kernel launched %d times for %d '
                  'batches (caps %s)' % (name, nl, nb, caps))
        else:
            check(nl == 0, '%s: expected the scatter path, the kernel '
                  'launched %d times' % (name, nl))
    main_launches = ck.launches['onehot_dense']
    main_s = time.monotonic() - t_main
    mod_ds.DeviceScan._try_device = orig_try
    ck.onehot_dense = orig_kernel
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
    return shapes, main_launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--records', type=int, default=2000000)
    ap.add_argument('--seed', type=int, default=12345)
    ap.add_argument('--reps', type=int, default=100)
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
    ck.build()
    ck._load()
    log('build: onehot_agg.cu in %.2f s' % (time.monotonic() - t0))

    # 2. kernel vs plain at the reference's test shapes (weighted) and
    # at one batch with each kernel query's caps (unit weights, as the
    # main path calls it)
    results = [check_kernel(ck, radices, n, False, args.reps)
               for radices, n in PALLAS_SHAPES]
    slice_results = [check_kernel(ck, radices, n, True, args.reps)
                     for radices, n in SLICE_SHAPES]
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
        os.environ['DN_TORCH_DEVICE'] = 'cuda'
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

        shapes, main_launches = main_path(cli, mod_ds, ck, ds,
                                          args.records)
    torch.cuda.synchronize()

    # the kernel at the shapes the main path gave it (the largest batch
    # of each accumulator shape)
    largest = {}
    for radices, n, weighted in shapes:
        key = (radices, weighted)
        largest[key] = max(largest.get(key, 0), n)
    log('main path kernel shapes (caps, largest batch): %s'
        % sorted(largest.items()))
    results += slice_results
    results += [check_kernel(ck, radices, n, not weighted, args.reps)
                for (radices, weighted), n in sorted(largest.items())]
    torch.cuda.synchronize()
    main = slice_results[0]
    log('gpu: %s' % card)
    print(json.dumps({'kernels': [{
        'name': 'onehot_dense', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': KERNEL_REPLACES, 'launches': main_launches,
        'max_abs_err': max(r['max_abs_err'] for r in results),
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'library_ms': main['library_ms'],
        'shape': {'radices': main['radices'], 'n': main['n']},
        'shapes': results}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
