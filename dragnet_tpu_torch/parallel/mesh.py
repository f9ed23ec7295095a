"""Mesh-sharded aggregation (K9).

Counterpart of dragnet_tpu/parallel/mesh.py.  The scan's reduce is a
commutative-monoid merge (sum of weights per key tuple), so a batch
distributes by its record axis: each device of the mesh aggregates an
equal slice locally, then the partials merge.  The reference runs the
local step under shard_map and merges with psum / psum_scatter (and
pmin for first occurrence) over ICI; here the local step is a kernel
launch on each device and the merge is torch ops on the devices that
keep the result:

* the local step is K1 (cuda_kernels.onehot_dense, the one-hot kernel)
  where cuda_kernels.should_use allows it, else an i64 index_add_
  (ops/kernels.make_aggregate).  On CPU tensors both take their plain
  versions,
* psum: every partial copied to the first device and added there,
* psum_scatter (tiled): shard s keeps the sum of slice s of every
  partial, on its own device,
* pmin: the device scan's first-occurrence rows merge with a min
  (merge_partials, called per batch by device_scan's mesh body, whose
  shards each run the scan program K2 into partials of their own).

A Mesh is an explicit device list, so one card can hold several shards
(make_mesh(devices=['cuda:0', 'cuda:0'])): the split, the padding and
the merges then run on that card as they would across cards.  `launches`
counts the merges, one key per caller, so a run can show the mesh path
ran.
"""

import numpy as np
import torch

from ..ops import resolve_device

launches = {'scan_merge': 0, 'aggregate_merge': 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _pin_index(dev):
    """A CUDA device with its index (torch.device('cuda') names the
    current device, which is not a fixed mesh position)."""
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


class Mesh(object):
    """An ordered list of torch devices along one axis.  Shard s of a
    batch runs on devices[s]; devices may repeat."""

    def __init__(self, devices, axis='d'):
        if not devices:
            raise ValueError('a mesh needs at least one device')
        self.devices = [_pin_index(resolve_device(d)) for d in devices]
        self.axis = axis

    @property
    def size(self):
        return len(self.devices)

    def names(self):
        return [str(d) for d in self.devices]

    def key(self):
        return (self.axis, tuple(self.names()))


def local_device_names(device=None):
    """The devices make_mesh(device=device) would use, by name, without
    initializing CUDA (torch.cuda.device_count does not create a
    context): what a dry run's plan reports."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        return ['cuda:%d' % i for i in range(torch.cuda.device_count())]
    return [str(dev)]


def make_mesh(devices=None, device=None, axis='d'):
    """A mesh over `devices` (torch devices or names) when given, else
    over the process-local devices of `device`'s type: every CUDA device
    of this process (the default), or the CPU when the caller asks for
    it.  Each process aggregates its own input partition on its own
    devices; processes merge at the points level (cluster.py).  Raises
    DNError when CUDA is asked for and absent."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == 'cuda':
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    return Mesh(devices, axis=axis)


def merge_partials(parts, device):
    """K9's merge for one device-scan batch: `parts` holds each shard's
    (dense i64[ns], first i64[ns], cvec i64[ncounters]), the partials its
    scan program (K2, and K1 on its route) added into; dense and the
    counters sum (psum), first takes the min (pmin: rows are global, so
    the min is the batch's first occurrence).  The result lives on
    `device`, the accumulator's, as (dense i64, first i64, cvec i64).
    The partials are consumed: the first shard's become the result,
    and each other shard's adds into them in place."""
    launches['scan_merge'] += 1
    dense, first, cvec = (t.to(device) for t in parts[0])
    cvec = cvec.to(torch.int64)
    for d, f, c in parts[1:]:
        dense += d.to(device)
        torch.minimum(first, f.to(device), out=first)
        cvec += c.to(device)
    return dense, first, cvec


def _local_step(radices, codes, weights, alive, use_kernel):
    from ..ops import cuda_kernels
    from ..ops.kernels import make_aggregate
    if use_kernel:
        return cuda_kernels.onehot_dense(radices, codes, weights, alive)
    return make_aggregate(tuple(radices))(codes, weights, alive)


def sharded_aggregate(key_codes, radices, weights, alive, scatter=False,
                      mesh=None):
    """Aggregate one batch across the mesh's devices.

    key_codes: [ncols, n] int64 (host); weights: [n] f64; alive: [n]
    bool.  Pads the record axis to a multiple of the device count (the
    padding rows are dead), runs each shard's local step on its device,
    merges the partials (psum, or with `scatter` a tiled psum_scatter:
    shard s keeps its disjoint slice of the segments), and returns the
    dense accumulator as f64 numpy.  Non-integer weights, or a total of
    2^31 or more, take the exact f64 host bincount (the reference's
    guard)."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size
    n = weights.shape[0]
    num_segments = 1
    for r in radices:
        num_segments *= int(r)
    if scatter and num_segments % ndev != 0:
        scatter = False

    int_w = bool(np.all(weights == np.floor(weights)))
    total = float(np.abs(weights).sum())
    if not (int_w and total < 2 ** 31):
        # exact-f64 host merge; it cannot keep the per-device-slice
        # contract of the scatter variant
        assert not scatter, 'scatter=True requires int32-safe weights'
        fused = np.zeros(n, dtype=np.int64)
        for i in range(len(radices)):
            fused = fused * int(radices[i]) + key_codes[i]
        w = np.where(alive, weights, 0.0)
        return np.bincount(fused, weights=w, minlength=num_segments)

    pad = (-n) % ndev
    if pad:
        key_codes = np.pad(key_codes, ((0, 0), (0, pad)))
        weights = np.pad(weights, (0, pad))
        alive = np.pad(alive, (0, pad))
    per = (n + pad) // ndev

    from ..ops import cuda_kernels
    use_kernel = cuda_kernels.should_use(num_segments, total)
    codes32 = np.asarray(key_codes, dtype=np.int32)
    w32 = np.asarray(weights, dtype=np.int32)
    alive = np.asarray(alive, dtype=bool)
    parts = []
    for s, dev in enumerate(mesh.devices):
        sl = slice(s * per, (s + 1) * per)
        parts.append(_local_step(
            radices,
            torch.from_numpy(np.ascontiguousarray(codes32[:, sl])).to(dev),
            torch.from_numpy(np.ascontiguousarray(w32[sl])).to(dev),
            torch.from_numpy(np.ascontiguousarray(alive[sl])).to(dev),
            use_kernel))
    launches['aggregate_merge'] += 1
    if scatter:
        seg = num_segments // ndev
        out = [torch.stack([p[s * seg:(s + 1) * seg].to(dev)
                            for p in parts]).sum(0).cpu()
               for s, dev in enumerate(mesh.devices)]
        dense = torch.cat(out)
    else:
        dev0 = mesh.devices[0]
        dense = torch.stack([p.to(dev0) for p in parts]).sum(0).cpu()
    return dense.numpy().astype(np.float64)
