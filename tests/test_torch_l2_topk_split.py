"""The brute-force scan's split plan (``kernels/l2_topk/ops.py::
plan_splits``) and a plain model of the split kernel, on the CPU.

The CUDA kernel cuts the base into the plan's tile-aligned row ranges,
keeps each range's k best per query, pads a short range's list with
(+inf, -1) and merges the lists by (distance, id).  Here the plan is held
to covering every row once with no empty range, and the plain model of
those steps to ``l2_topk_ref`` and to the JAX ``l2_topk_pallas`` in
interpret mode.  Inputs with small integer coordinates make every
distance exact in float32, so the model must equal ``l2_topk_ref``
bit for bit (as the kernel's split equals its one split on the card);
normal inputs are held at rtol 1e-5 with ids equal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_topk import l2_topk as j_l2_topk
from repro_torch.kernels.l2_topk import ops
from repro_torch.kernels.l2_topk.ref import l2_topk_ref
from _torch_threads import _one_torch_thread  # noqa: F401

SMS = ops.H100_SMS
RTOL, ATOL = 1e-5, 1e-5


def _cap(N, k, tn):
    """The most splits the caps allow once rounded to equal tile counts."""
    n_tiles = math.ceil(N / tn)
    s_max = max(1, min(n_tiles, ops.MAX_SPLITS, ops.MERGE_ENTRIES // k))
    return math.ceil(n_tiles / math.ceil(n_tiles / s_max))


@pytest.mark.parametrize("k", [1, 10, 100, 2048])
@pytest.mark.parametrize("N", [130, 4_000, 53_387])
@pytest.mark.parametrize("B", [1, 37, 256, 10_000])
def test_plan_splits_covers_every_row_once(B, N, k):
    if k > N:
        with pytest.raises(ValueError):
            ops.plan_splits(B, N, k, SMS)
        return
    p = ops.plan_splits(B, N, k, SMS)
    assert p.tq == (128 if k <= 32 and B >= 4096 else
                    32 if k <= 256 and B >= 32 else 8)
    assert p.tn == ops.TILE_ROWS[p.tq]
    ranges = p.ranges(N)
    assert len(ranges) == p.splits and ranges[0][0] == 0
    assert ranges[-1][1] == N
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(N, N)]):
        assert lo % p.tn == 0 and lo < hi and hi == nxt     # aligned, no gap
        assert hi - lo <= p.split_tiles * p.tn
    assert p.splits * k <= ops.MERGE_ENTRIES and p.splits <= ops.MAX_SPLITS
    # the blocks fill the card, or come within half of it where the caps
    # (merge entries, tiles) allow no more
    blocks = math.ceil(B / p.tq) * p.splits
    cap = math.ceil(B / p.tq) * _cap(N, k, p.tn)
    assert 2 * blocks >= min(SMS, cap)
    assert ops.smem_bytes(p.tq, k) <= 232_448              # a block's limit


@pytest.mark.parametrize("B, N, k, tq, want", [
    (1, 53_387, 10, 8, 209),        # a single query: one tile a split
    (256, 53_387, 10, 32, 33),      # the serving batch: 8 x 33 blocks
    (256, 53_387, 100, 32, 33),
    (1_000, 4_000, 10, 32, 8),      # phase 4c's ground truth
    (10_000, 53_387, 10, 128, 5),   # phase 4's: 79 query tiles x 5 splits
    (3, 130, 50, 8, 1),             # one tile: no split, no merge
])
def test_plan_splits_at_the_main_paths_shapes(B, N, k, tq, want):
    p = ops.plan_splits(B, N, k, SMS)
    assert (p.tq, p.splits) == (tq, want)


def test_forced_splits():
    p = ops.plan_splits(256, 53_387, 10, SMS, splits=1)
    assert p.splits == 1 and p.split_tiles == math.ceil(53_387 / p.tn)
    # 3 splits of 70 tiles cover 209
    p = ops.plan_splits(1, 53_387, 10, SMS, splits=3)
    assert (p.splits, p.split_tiles) == (3, 70)
    for bad in (0, 210):
        with pytest.raises(ValueError):
            ops.plan_splits(1, 53_387, 10, SMS, splits=bad)
    with pytest.raises(ValueError):                 # 41 x 100 > 4096 entries
        ops.plan_splits(1, 53_387, 100, SMS, splits=41)


def l2_topk_split_ref(queries, base, k, ranges, squared=False):
    """The kernel's split plan in plain PyTorch: ``l2_topk_ref`` over each
    row range [start, end) of ``ranges`` (``ops.SplitPlan.ranges``), each
    list padded with (+inf, -1) to k, then merged by (distance, id) with
    the padding skipped."""
    ds, ids = [], []
    for lo, hi in ranges:
        d, i = l2_topk_ref(queries, base[lo:hi], min(k, hi - lo), squared)
        pad = k - d.shape[1]
        ds.append(torch.nn.functional.pad(d, (0, pad), value=torch.inf))
        ids.append(torch.nn.functional.pad(i + lo, (0, pad), value=-1))
    d, i = torch.cat(ds, dim=1), torch.cat(ids, dim=1)
    # by id (padding last), then stably by distance: (distance, id) order
    order = torch.argsort(torch.where(i < 0, torch.iinfo(torch.int32).max, i),
                          dim=1, stable=True)
    d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def _inputs(B, N, m, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-3, 4, size=(B, m)).astype(np.float32)
        x = rng.integers(-3, 4, size=(N, m)).astype(np.float32)
    else:
        q = rng.normal(size=(B, m)).astype(np.float32)
        x = rng.normal(size=(N, m)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("B, N, m, k, splits", [
    (5, 600, 16, 10, 3),            # three Narrow tiles, one a split
    (5, 600, 16, 10, 2),            # two splits, the last one short
    (7, 300, 9, 50, 2),             # the second split holds 44 < k rows
    (4, 1_100, 33, 7, None),        # the plan's own split (5 splits)
    (1, 520, 8, 1, 3),
])
def test_split_model_matches_ref_and_jax(B, N, m, k, splits, integer,
                                         squared):
    q, x = _inputs(B, N, m, B * N + k, integer)
    plan = ops.plan_splits(B, N, k, SMS, splits)
    assert plan.splits == (splits or 5)
    d, i = l2_topk_split_ref(torch.from_numpy(q), torch.from_numpy(x), k,
                             plan.ranges(N), squared)
    rd, ri = l2_topk_ref(torch.from_numpy(q), torch.from_numpy(x), k,
                         squared)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    if integer:
        assert torch.equal(d, rd) and torch.equal(i, ri)
    else:
        torch.testing.assert_close(d, rd, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(i.numpy(), ri.numpy())
    jd, ji = j_l2_topk(jnp.asarray(q), jnp.asarray(x), k, squared=squared,
                       interpret=True)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_ties_across_a_split_boundary_go_to_the_lower_id():
    """Equal rows on both sides of the boundaries at 256 and 512 (and two
    inside a split): each query's tied rows come back in id order, as
    from the unsplit scan and the JAX kernel."""
    rng = np.random.default_rng(7)
    x = rng.integers(-3, 4, size=(600, 8)).astype(np.float32) * 4
    for a, b, v in ((255, 256, 0.5), (511, 512, -0.5), (100, 130, 1.5)):
        x[a] = x[b] = v
    q = np.full((3, 8), 0.5, np.float32)
    q[1], q[2] = -0.5, 1.5
    plan = ops.plan_splits(3, 600, 4, SMS, splits=3)
    assert [lo for lo, _ in plan.ranges(600)] == [0, 256, 512]
    d, i = l2_topk_split_ref(torch.from_numpy(q), torch.from_numpy(x), 4,
                             plan.ranges(600))
    np.testing.assert_array_equal(i[:, :2].numpy(),
                                  [[255, 256], [511, 512], [100, 130]])
    assert bool((d[:, 0] == 0).all() and (d[:, 1] == 0).all())
    rd, ri = l2_topk_ref(torch.from_numpy(q), torch.from_numpy(x), 4)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    _, ji = j_l2_topk(jnp.asarray(q), jnp.asarray(x), 4, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_splits_keyword_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version whatever S is
    asked for; an S the caps forbid is refused all the same."""
    q, x = _inputs(3, 700, 12, 0, False)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    for s in (1, 3):
        for a, b in zip(ops.l2_topk(tq, tx, 5, splits=s),
                        l2_topk_ref(tq, tx, 5)):
            assert torch.equal(a, b)
    for bad in (0, 4):                              # 700 rows: 3 tiles
        with pytest.raises(ValueError, match="splits"):
            ops.l2_topk(tq, tx, 5, splits=bad)
