"""Scan kernels in plain torch: bucketize helpers, the ternary and/or
fold, and the i64 segment-sum aggregation.

Counterpart of dragnet_tpu/ops/kernels.py.  Semantics contract (pinned
by differential tests against the JAX functions):

* p2: v < 1 -> 0; v >= 1 -> floor(log2 v) + 1   (DTrace quantize)
* linear: floor(v / step)
* predicate outcomes are ternary (FALSE/TRUE/ERROR) folding with JS
  short-circuit rules: `and` -> first non-true, `or` -> first non-false
* fuse + segment-sum: mixed-radix composite key into a dense
  accumulator; partials merge by addition

Sums are integer (int64 index_add_), so they are exact and independent
of the order in which CUDA's atomics land.
"""

import torch

FALSE, TRUE, ERROR = 0, 1, 2


def p2_bucketize(v):
    """f32 values -> i32 p2 bucket ordinals, exact at bucket boundaries
    (log2 with a +-1 fix-up, the reference's formulation)."""
    v = v.to(torch.float32)
    e = torch.floor(torch.log2(torch.clamp_min(v, 1.0))).to(torch.int32)
    pow_e = torch.exp2(e.to(torch.float32))
    e = torch.where(pow_e > v, e - 1, e)
    e = torch.where(pow_e * 2.0 <= v, e + 1, e)
    return torch.where(v < 1, torch.zeros_like(e), e + 1)


def linear_bucketize(v, step):
    return torch.floor(v / step).to(torch.int32)


def fold_and(outcomes):
    """outcomes: list of i8 tensors; first non-TRUE operand wins."""
    state = outcomes[0]
    for o in outcomes[1:]:
        state = torch.where(state == TRUE, o, state)
    return state


def fold_or(outcomes):
    """first non-FALSE operand wins."""
    state = outcomes[0]
    for o in outcomes[1:]:
        state = torch.where(state == FALSE, o, state)
    return state


def fuse_keys(radices, codes):
    """Mixed-radix fused key (i64) of per-column codes [ncols, n]."""
    fused = codes[0].to(torch.int64)
    for i in range(1, len(radices)):
        # codes[i] + fused * radix, one kernel a column
        fused = torch.add(codes[i], fused, alpha=int(radices[i]))
    return fused


def make_aggregate(radices):
    """(codes[ncols, n] i32, weights[n] i32, alive[n] bool) -> dense
    i64 accumulator of prod(radices).
    Dead records go to an overflow slot that is dropped."""
    num_segments = 1
    for r in radices:
        num_segments *= int(r)

    def agg(codes, weights, alive):
        fused = torch.where(alive, fuse_keys(radices, codes),
                            num_segments)
        w = torch.where(alive, weights.to(torch.int64), 0)
        dense = torch.zeros(num_segments + 1, dtype=torch.int64,
                            device=codes.device)
        dense.index_add_(0, fused, w)
        return dense[:num_segments]

    return agg
