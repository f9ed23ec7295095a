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


@pytest.mark.cuda
@pytest.mark.parametrize('radices,n', PALLAS_SHAPES + [((8, 32), 65536)])
def test_onehot_kernel_matches_plain_on_card(radices, n):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    codes, w, alive = _inputs(radices, n, seed=2)
    dev = torch.device('cuda')
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
