"""The port's kernels (dragnet_tpu_torch/ops) against the JAX package's:
bucketize helpers, the ternary fold, the i64 segment-sum, the one-hot
aggregation's plain version against the Pallas kernel in interpret mode,
and the routing gate.  Inputs come from seeded numpy; every comparison
is exact (the sums are integers).  The CUDA kernel itself is compared
with its plain version only where a card is present."""

import numpy as np
import pytest
import torch

from dragnet_tpu.ops import get_jax
from dragnet_tpu.ops import kernels as jk
from dragnet_tpu.ops import pallas_kernels as jpk
from dragnet_tpu_torch.ops import kernels as tk
from dragnet_tpu_torch.ops import cuda_kernels as tck

PALLAS_SHAPES = [
    ((8, 64), 1000),       # capacity not block-aligned
    ((3, 5, 7), 4096),     # segments far below one block
    ((513,), 700),         # segment pad crosses a block boundary
    ((8, 16, 32), 8192),   # MAX_PALLAS_SEGMENTS boundary
]


def _jnp():
    j = get_jax()
    if j is None:
        pytest.skip('jax unavailable')
    return j[1]


def _inputs(radices, n, seed, weights=True):
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, r, n)
                      for r in radices]).astype(np.int32)
    w = rng.integers(-3, 10, n).astype(np.int32) if weights else None
    alive = rng.random(n) < 0.9
    return codes, w, alive


def _bucket_values():
    rng = np.random.default_rng(3)
    pows = [float(2 ** k) for k in range(0, 30)]
    edges = [p - 1 for p in pows] + [p + 1 for p in pows]
    small = [0.0, 0.25, 0.5, 0.999, -0.5, -1.0, -7.0, -1e6]
    rand = list(rng.uniform(-1e6, 1e9, 500)) + \
        list(rng.integers(-5000, 5000, 500).astype(float))
    return np.array(pows + edges + small + rand, dtype=np.float32)


def test_p2_bucketize_matches_jax():
    """Both follow the DTrace quantize contract (v < 1 -> 0, else
    frexp's exponent).  The port meets it everywhere.  The JAX function
    runs here on XLA:CPU, whose f32 exp2 is inexact near some large
    powers of two, so its +-1 fix-up misses there: every value on which
    the two disagree must be one where the JAX result breaks the
    contract."""
    jnp = _jnp()
    v = _bucket_values()
    truth = np.where(v < 1, 0, np.frexp(v.astype(np.float64))[1])
    want = np.asarray(jk.p2_bucketize(jnp, jnp.asarray(v)))
    got = tk.p2_bucketize(torch.from_numpy(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, truth)
    differ = got != want
    np.testing.assert_array_equal(want[~differ], truth[~differ])
    assert np.all(want[differ] != truth[differ])
    assert differ.sum() < len(v) // 50


@pytest.mark.parametrize('step', [1, 7, 60, 3600])
def test_linear_bucketize_matches_jax(step):
    jnp = _jnp()
    v = _bucket_values()
    want = np.asarray(jk.linear_bucketize(jnp, jnp.asarray(v), step))
    got = tk.linear_bucketize(torch.from_numpy(v), step).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('fold', ['fold_and', 'fold_or'])
def test_fold_matches_jax(fold):
    jnp = _jnp()
    rng = np.random.default_rng(5)
    outs = [rng.integers(0, 3, 400).astype(np.int8) for _ in range(4)]
    want = np.asarray(getattr(jk, fold)(jnp, [jnp.asarray(o)
                                              for o in outs]))
    got = getattr(tk, fold)([torch.from_numpy(o) for o in outs]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('radices,n', PALLAS_SHAPES)
def test_make_aggregate_matches_jax(radices, n):
    _jnp()
    codes, w, alive = _inputs(radices, n, seed=11)
    want = np.asarray(jk.make_aggregate(radices, n, True)(codes, w, alive))
    got = tk.make_aggregate(radices)(
        torch.from_numpy(codes), torch.from_numpy(w),
        torch.from_numpy(alive))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('radices,n', PALLAS_SHAPES)
def test_onehot_ref_matches_pallas_interpret(radices, n):
    """The plain version equals the Pallas kernel (interpret mode), as
    test_pallas.py drives it: integral f32 weights, 90% alive."""
    _jnp()
    rng = np.random.default_rng(0)
    codes = np.stack([rng.integers(0, r, n)
                      for r in radices]).astype(np.int32)
    w = rng.integers(1, 10, n).astype(np.float32)
    alive = rng.random(n) < 0.9
    agg = jpk.make_pallas_aggregate(radices, n, interpret=True)
    want = np.asarray(agg(codes, w, alive))
    got = tck.onehot_dense(radices, torch.from_numpy(codes),
                           torch.from_numpy(w.astype(np.int32)),
                           torch.from_numpy(alive))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_onehot_ref_unit_weights_and_bounds():
    """weights=None means all-ones; keys outside [0, ns) drop out."""
    radices = (4, 8)
    codes = np.array([[0, 1, 3, 5, -1, 2], [7, 0, 7, 0, 3, 9]],
                     dtype=np.int32)
    alive = np.array([True, True, False, True, True, True])
    got = tck.onehot_dense_ref(radices, torch.from_numpy(codes), None,
                               torch.from_numpy(alive)).numpy()
    want = np.zeros(32, dtype=np.int64)
    want[[7, 8, 25]] = 1    # (0,7), (1,0), (2,9); (3,7) is dead
    # (5,0) -> 40 and (-1,3) -> -5 fall outside [0, 32)
    np.testing.assert_array_equal(got, want)


def test_gate_matches_reference():
    for ns in (-1, 0, 1, 2, 511, 512, 4095, 4096, 4097, 8192, 1 << 20):
        assert tck.segments_ok(ns) == jpk.pallas_ok(ns), ns
        for total in (0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 31):
            want = jpk.pallas_ok(ns) and total < 2 ** 24
            assert tck.should_use(ns, total) == want, (ns, total)


def test_wrapper_rejects_bad_inputs():
    codes = torch.zeros((2, 10), dtype=torch.int32)
    alive = torch.ones(10, dtype=torch.bool)
    tck._check((4, 4), codes, None, alive)
    bad = [
        ((4, 4), codes.to(torch.int64), None, alive),       # dtype
        ((4, 4), codes, None, alive[:5]),                   # shape
        ((4,), codes, None, alive),                         # ncols
        ((64, 128), codes, None, alive),                    # segments
        ((4, 4), codes.t().contiguous().t(), None, alive),  # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tck._check(*args)
    with pytest.raises(ValueError):
        tck.onehot_dense((4, 4), codes.to('meta'), None, alive.to('meta'))


def _fused_dead(radices, codes, alive, rng, dtype):
    """The fused key of codes with dead rows at values outside [0, ns):
    ns itself (as the device scan writes them), -1, and far off."""
    ns = int(np.prod(radices))
    fused = np.zeros(codes.shape[1], dtype=np.int64)
    for c, r in zip(codes, radices):
        fused = fused * r + c
    dead = rng.choice(np.array([ns, -1, ns + 7, -(1 << 20)]),
                      codes.shape[1])
    return np.where(alive, fused, dead).astype(dtype)


@pytest.mark.parametrize('key_dtype', [np.int32, np.int64])
@pytest.mark.parametrize('radices,n', PALLAS_SHAPES)
def test_onehot_into_ref_matches_pallas_interpret(radices, n, key_dtype):
    """The kernel's own entry, plain version: from the fused key (i32 or
    i64, dead rows anywhere outside [0, ns)), added into a non-zero
    accumulator, equals that accumulator plus the Pallas kernel
    (interpret mode) on the same records."""
    _jnp()
    rng = np.random.default_rng(0)
    codes, w, alive = _inputs(radices, n, seed=7)
    agg = jpk.make_pallas_aggregate(radices, n, interpret=True)
    want = np.asarray(agg(codes, w.astype(np.float32), alive)).astype(
        np.int64)
    out0 = rng.integers(-1 << 40, 1 << 40, want.shape[0])
    out = torch.from_numpy(out0.copy())
    fused = torch.from_numpy(_fused_dead(radices, codes, alive, rng,
                                         key_dtype))
    got = tck.onehot_dense_into(out, fused, torch.from_numpy(w))
    assert got is out and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), out0 + want)


def test_onehot_into_ref_unit_weights_and_empty():
    """weights=None adds one per record; n = 0 leaves out as it was."""
    out0 = np.arange(8, dtype=np.int64) * 10
    out = torch.from_numpy(out0.copy())
    fused = torch.tensor([3, 3, 7, 8, -1, 0, 3], dtype=torch.int32)
    tck.onehot_dense_into_ref(out, fused, None)
    want = out0.copy()
    want[[0, 3, 7]] += [1, 3, 1]
    np.testing.assert_array_equal(out.numpy(), want)
    tck.onehot_dense_into(out, torch.zeros(0, dtype=torch.int64), None)
    np.testing.assert_array_equal(out.numpy(), want)


def test_into_wrapper_rejects_bad_inputs():
    out = torch.zeros(16, dtype=torch.int64)
    fused = torch.zeros(10, dtype=torch.int32)
    w = torch.ones(10, dtype=torch.int32)
    assert tck._check_into(out, fused, w) == 16
    assert tck._check_into(out, fused.to(torch.int64), None) == 16
    bad = [
        (out.to(torch.int32), fused, w),                  # out dtype
        (out.reshape(4, 4), fused, w),                    # out rank
        (torch.zeros(0, dtype=torch.int64), fused, w),    # no segments
        (torch.zeros(4097, dtype=torch.int64), fused, w),  # > 4096
        (out[::2], fused, w),                             # out layout
        (out, fused.to(torch.float32), w),                # key dtype
        (out, fused.reshape(2, 5), w),                    # key rank
        (out, torch.zeros(20, dtype=torch.int32)[::2], w),  # key layout
        (out, fused, w.to(torch.int64)),                  # weight dtype
        (out, fused, w[:5]),                              # weight shape
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tck._check_into(*args)
    with pytest.raises(ValueError):
        tck.onehot_dense_into(out.to('meta'), fused.to('meta'), None)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _card_keys(kind, ns, n, seed):
    """i32 fused keys as chip_smoke.py times them: uniform, every live
    row on one bin, or linear-timestamp runs; dead rows at ns."""
    rng = np.random.default_rng(seed)
    if kind == 'uniform':
        keys = rng.integers(0, ns, n)
    elif kind == 'one bin':
        keys = np.full(n, ns // 3)
    else:
        keys = ((np.arange(n) * 7 // n) * 16 + rng.integers(0, 7, n)) % ns
    keys[rng.random(n) < 0.1] = ns
    return keys.astype(np.int32)


def _card_check(dev, keys, w, ns, seed):
    """Kernel against its plain version into the same non-zero out,
    with one launch counted."""
    out0 = torch.from_numpy(np.random.default_rng(seed).integers(
        -1 << 40, 1 << 40, ns)).to(dev)
    fused = torch.from_numpy(keys).to(dev) if isinstance(
        keys, np.ndarray) else keys
    wt = None if w is None else torch.from_numpy(w).to(dev)
    before = tck.launches['onehot_dense']
    got = tck.onehot_dense_into(out0.clone(), fused, wt)
    torch.cuda.synchronize()
    assert tck.launches['onehot_dense'] == before + 1
    want = tck.onehot_dense_into_ref(out0.clone(), fused, wt)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['uniform', 'linear ts', 'one bin'])
@pytest.mark.parametrize('ns', [256, 512, 1024, 2048, 4096])
def test_onehot_into_kernel_sweep_on_card(ns, kind):
    """The main path's batch size at every segment count the gate sends
    to the kernel, on uniform and skewed keys."""
    dev = _cuda()
    _card_check(dev, _card_keys(kind, ns, 74800, ns), None, ns, 1)


@pytest.mark.cuda
def test_onehot_into_kernel_large_on_card():
    """2,000,000 records: several clusters merge with atomics."""
    dev = _cuda()
    _card_check(dev, _card_keys('uniform', 4096, 2000000, 3), None, 4096,
                2)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [0, 1, 5, 1000, 74801])
def test_onehot_into_kernel_signed_i64_unaligned_on_card(n):
    """Signed weights, i64 and i32 keys with dead rows anywhere outside
    [0, ns), and a key tensor that starts off a 16-byte boundary (the
    scalar load path)."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    ns = 4096
    keys = rng.integers(-5, ns + 5, n + 1)
    w = rng.integers(-3, 10, n).astype(np.int32)
    _card_check(dev, keys[:n], w, ns, 3)
    _card_check(dev, keys[:n].astype(np.int32), None, ns, 4)
    shifted = torch.from_numpy(keys.astype(np.int32)).to(dev)[1:]
    _card_check(dev, shifted, w, ns, 5)


@pytest.mark.cuda
@pytest.mark.parametrize('radices,n', PALLAS_SHAPES + [((8, 32), 65536)])
def test_onehot_kernel_matches_plain_on_card(radices, n):
    dev = _cuda()
    codes, w, alive = _inputs(radices, n, seed=2)
    args = (torch.from_numpy(codes).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(alive).to(dev))
    before = tck.launches['onehot_dense']
    got = tck.onehot_dense(radices, *args)
    torch.cuda.synchronize()
    assert tck.launches['onehot_dense'] == before + 1
    want = tck.onehot_dense_ref(radices, *args)
    assert torch.equal(got, want)
    got1 = tck.onehot_dense(radices, args[0], None, args[2])
    assert torch.equal(got1, tck.onehot_dense_ref(radices, args[0], None,
                                                  args[2]))


@pytest.mark.cuda
def test_stream_handle_matches_public_api_on_card():
    """The wrapper's private raw-stream lookup gives the handle of
    torch.cuda.current_stream, on the default stream and on a side
    stream, and the kernel launched under a side stream lands there."""
    dev = torch.device(_cuda().type, torch.cuda.current_device())
    assert tck.current_stream_handle(dev.index) == \
        torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert tck.current_stream_handle(dev.index) == side.cuda_stream
        keys = torch.from_numpy(_card_keys('uniform', 256, 74800, 6)).to(
            dev)
        got = tck.onehot_dense_into(
            torch.zeros(256, dtype=torch.int64, device=dev), keys, None)
    side.synchronize()
    want = tck.onehot_dense_into_ref(
        torch.zeros(256, dtype=torch.int64, device=dev), keys, None)
    assert torch.equal(got, want)
