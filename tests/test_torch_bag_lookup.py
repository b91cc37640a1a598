"""The embedding-bag kernel's plain version (what a CPU tensor runs, and
what ``chip_smoke.py`` holds the CUDA kernel against on the card) and the
port's ``models/embedding_bag.py`` against the JAX package.

* ``bag_lookup``: against the JAX wrapper with the Pallas kernel in
  interpret mode and against ``bag_lookup_ref``, on ``tests/test_kernels.py``'s
  three shapes, at rtol 1e-5 / atol 1e-6 (both sum F products in float32,
  in orders that may differ); invalid ids, ids >= V, the unweighted
  default, F = 0, B = 0 and half tables besides.
* ``embedding_bag_fixed`` (sum, mean, weighted), ``embedding_bag_ragged``,
  ``embedding_bag_max`` and ``stack_vocab_offsets`` against
  ``repro.models.embedding_bag``: the same tolerance, offsets exactly.
* The gradient: ``bag_lookup_bwd``'s plain version and the autograd
  Function ``BagLookup`` (through ``embedding_bag_fixed``, sum and mean)
  against ``jax.vjp`` of the JAX ``embedding_bag_fixed``, with -1
  padding, ids >= V, a row named F times in one bag and Zipf-skewed ids,
  weighted and not, at rtol 1e-6 of the sum of the magnitudes each entry
  adds (``_assert_grad``); a float64 ``gradcheck`` of the Function; a
  numpy model of the kernel's sorted, chunked order
  (``csrc/bag_lookup_bwd.cu`` runs only on a card), with the history's
  cotangent G and without, against the plain ``grad_table`` at every
  chunk size; ``bwd_order``'s plain order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bag_lookup import bag_lookup as j_bag_lookup
from repro.kernels.bag_lookup import bag_lookup_ref as j_bag_lookup_ref
from repro.models import embedding_bag as jeb
from repro_torch.kernels.bag_lookup import ops as bag_ops
from repro_torch.kernels.bag_lookup.ref import bag_lookup_ref
from repro_torch.models import embedding_bag as teb
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
INVALID = -1
T = torch.from_numpy


def _inputs(V, E, B, F, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, E)).astype(np.float32)
    ids = rng.integers(0, V, size=(B, F)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, size=(B, F)).astype(np.float32)
    return rng, table, ids, w


@pytest.mark.parametrize("V,E,B,F,dcn", [
    pytest.param(1000, 16, 8, 26, False, id="1000-16-8-26"),   # DLRM-ish
    pytest.param(37, 7, 3, 5, False, id="37-7-3-5"),           # tiny unaligned
    pytest.param(5000, 128, 4, 13, False, id="5000-128-4-13"),
    # DCN-v2's user embedding at retrieval_cand and serve_p99: F=26, E=16,
    # no weights, rows at init_params' 0.01 scale
    pytest.param(1000, 16, 1, 26, True, id="1000-16-1-26-dcn"),
    pytest.param(1000, 16, 512, 26, True, id="1000-16-512-26-dcn"),
])
def test_bag_lookup_plain_matches_jax(V, E, B, F, dcn):
    _, table, ids, w = _inputs(V, E, B, F, V + E)
    if dcn:
        table, w = table * np.float32(0.01), np.ones_like(w)
    got = bag_ops.bag_lookup(T(table), T(ids), T(w)).numpy()
    want = np.asarray(j_bag_lookup(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = np.asarray(j_bag_lookup_ref(jnp.asarray(table), jnp.asarray(ids),
                                      jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bag_lookup_ref(T(table), T(ids), T(w)).numpy(),
                               ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_bag_lookup_invalid_and_out_of_range_ids(weighted):
    """An id < 0 gets weight 0 and an id >= V is clipped to V - 1, as the
    JAX wrapper masks and clips them."""
    V, E, B, F = 50, 8, 6, 9
    rng, table, ids, w = _inputs(V, E, B, F, 6)
    ids[rng.random((B, F)) < 0.3] = INVALID
    ids[0, :4] = [V, V + 7, INVALID, 2 * V]
    ids[1, :] = INVALID                                  # an empty bag
    w = w if weighted else None
    got = bag_ops.bag_lookup(T(table), T(ids),
                             None if w is None else T(w)).numpy()
    want = np.asarray(j_bag_lookup(jnp.asarray(table), jnp.asarray(ids),
                                   None if w is None else jnp.asarray(w),
                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1], np.zeros(E, np.float32))


def test_bag_lookup_unweighted_default():
    _, table, ids, _ = _inputs(20, 4, 5, 3, 7)
    got = bag_ops.bag_lookup(T(table), T(ids)).numpy()
    want = np.asarray(j_bag_lookup_ref(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.ones((5, 3))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float64])
def test_bag_lookup_casts_the_table_to_float32(dtype):
    """A table of another float type is cast to float32 first, as the JAX
    wrapper casts it; the result is float32."""
    _, table, ids, w = _inputs(40, 12, 4, 6, 9)
    t = T(table).to(dtype)
    got = bag_ops.bag_lookup(t, T(ids), T(w))
    assert got.dtype == torch.float32
    want = np.asarray(j_bag_lookup(jnp.asarray(t.to(torch.float32).numpy()),
                                   jnp.asarray(ids), jnp.asarray(w),
                                   interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,F", [(0, 4), (3, 0), (0, 0)])
def test_bag_lookup_empty_shapes(B, F):
    table = T(np.ones((10, 5), np.float32))
    out = bag_ops.bag_lookup(table, torch.zeros((B, F), dtype=torch.int32),
                             torch.ones((B, F)))
    assert out.shape == (B, 5) and out.dtype == torch.float32
    assert not out.any()


def test_bag_lookup_rejects_what_the_kernel_does_not_take():
    table = torch.zeros((4, 8))
    with pytest.raises(ValueError):                      # int64 ids
        bag_ops.bag_lookup(table, torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(TypeError):                       # an integer table
        bag_ops.bag_lookup(torch.zeros((4, 8), dtype=torch.int32),
                           torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):                      # weights' shape
        bag_ops.bag_lookup(table, torch.zeros((1, 2), dtype=torch.int32),
                           torch.ones((2, 1)))
    with pytest.raises(ValueError, match="impl"):
        bag_ops.bag_lookup(table, torch.zeros((1, 2), dtype=torch.int32),
                           impl="triton")


def test_bag_lookup_on_the_cpu_launches_nothing():
    """A CPU tensor takes the plain version whatever ``impl`` says, and the
    launch counter does not move."""
    _, table, ids, w = _inputs(30, 6, 4, 5, 11)
    before = bag_ops.launches
    a = bag_ops.bag_lookup(T(table), T(ids), T(w))
    b = bag_ops.bag_lookup(T(table), T(ids), T(w), impl="ref")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bag_ops.launches == before


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_fixed_matches_jax(combiner, weighted):
    V, E, B, F = 60, 10, 7, 8
    rng, table, ids, w = _inputs(V, E, B, F, 12)
    ids[rng.random((B, F)) < 0.25] = INVALID
    ids[0, 0] = V + 3                                    # clipped
    ids[2, :] = INVALID                                  # mean over nothing
    w = w if weighted else None
    got = teb.embedding_bag_fixed(T(table), T(ids),
                                  None if w is None else T(w), combiner)
    want = jeb.embedding_bag_fixed(jnp.asarray(table), jnp.asarray(ids),
                                   None if w is None else jnp.asarray(w),
                                   combiner)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_embedding_bag_fixed_rejects_an_unknown_combiner():
    with pytest.raises(ValueError):
        teb.embedding_bag_fixed(torch.zeros((4, 2)),
                                torch.zeros((1, 2), dtype=torch.int32),
                                combiner="max")


def _ragged(seed, V=40, E=6, num_bags=7, n=30):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, E)).astype(np.float32)
    flat = rng.integers(0, V, size=n).astype(np.int32)
    seg = np.sort(rng.integers(0, num_bags, size=n)).astype(np.int32)
    seg[seg == 3] = 4                                    # bag 3 stays empty
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return table, flat, seg, w, num_bags


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_ragged_matches_jax(combiner, weighted):
    table, flat, seg, w, nb = _ragged(13)
    w = w if weighted else None
    got = teb.embedding_bag_ragged(T(table), T(flat), T(seg), nb,
                                   None if w is None else T(w), combiner)
    want = jeb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                    jnp.asarray(seg), nb,
                                    None if w is None else jnp.asarray(w),
                                    combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_embedding_bag_ragged_equals_fixed():
    """The two layouts agree on equivalent inputs (the JAX package's
    ``test_recsys_embedding_bag_consistency``)."""
    rng = np.random.default_rng(14)
    table = T(rng.normal(size=(50, 8)).astype(np.float32))
    ids = rng.integers(0, 50, size=(6, 4)).astype(np.int32)
    fixed = teb.embedding_bag_fixed(table, T(ids))
    seg = np.repeat(np.arange(6, dtype=np.int32), 4)
    ragged = teb.embedding_bag_ragged(table, T(ids.reshape(-1)), T(seg), 6)
    torch.testing.assert_close(fixed, ragged, rtol=RTOL, atol=ATOL)


def test_embedding_bag_max_matches_jax():
    """Including an empty bag, which is -inf on both sides."""
    table, flat, seg, _, nb = _ragged(15)
    got = teb.embedding_bag_max(T(table), T(flat), T(seg), nb).numpy()
    want = np.asarray(jeb.embedding_bag_max(jnp.asarray(table),
                                            jnp.asarray(flat),
                                            jnp.asarray(seg), nb))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[3]).all()


@pytest.mark.parametrize("vocab", [(30,) * 5, (63001, 801, 192403),
                                   (1460, 583, 10131227, 2202608, 3)])
def test_stack_vocab_offsets_matches_jax(vocab):
    total, off = teb.stack_vocab_offsets(vocab)
    jtotal, joff = jeb.stack_vocab_offsets(vocab)
    assert total == jtotal and off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


# ---------------------------------------------------------------------------
# the gradient: bag_lookup_bwd's plain version, the autograd Function, and
# a model of the kernel's chunked, sorted order
# ---------------------------------------------------------------------------
# the gradient's tolerance: rtol 1e-6 of the sum of the magnitudes each
# entry adds (|got - want| <= 1e-6 * sum |terms| + 1e-7).  Both packages
# add the same float32 products, in different orders, so an entry that
# cancels keeps an error of its terms' scale, not of its own.
BWD_RTOL, BWD_ATOL = 1e-6, 1e-7


def _assert_grad(got, want, mag, what):
    err = np.abs(np.asarray(got) - np.asarray(want))
    bound = BWD_RTOL * mag + BWD_ATOL
    assert (err <= bound).all(), (
        f"{what}: {int((err > bound).sum())} entries off, worst "
        f"{float((err - bound).max()):.3g} past the bound")


def _magnitudes(table, ids, w, g, combiner="sum"):
    """sum |terms| of grad_w (B, F) and grad_table (V, E).  Under "mean"
    g is divided by each bag's weight sum, and dL/dw also takes the
    division's term, out[b] . g[b] / sum."""
    V, E = table.shape
    valid = ids >= 0
    safe = np.clip(ids, 0, V - 1)
    wv = valid * (1.0 if w is None else w)
    extra = 0.0
    if combiner == "mean":
        den = np.maximum(wv.sum(1, keepdims=True), 1.0)
        g = g / den
        out = (table[safe] * wv[..., None]).sum(1) / den
        extra = np.abs(out * g).sum(-1, keepdims=True)
    mag_w = np.where(valid, np.abs(table[safe] * g[:, None, :]).sum(-1)
                     + extra, 0)
    ww = valid.astype(np.float64) * (1.0 if w is None else np.abs(w))
    mag_t = np.zeros((V, E))
    np.add.at(mag_t, safe.reshape(-1),
              (ww[..., None] * np.abs(g)[:, None, :]).reshape(-1, E))
    return mag_w, mag_t


def _bwd_inputs(V, E, B, F, seed, zipf=False):
    """Inputs with -1 padding, ids >= V (clipped), duplicates and, with
    ``zipf``, the stream's Zipf-skewed ids (a = 1.3: most entries on a few
    rows)."""
    rng, table, ids, w = _inputs(V, E, B, F, seed)
    if zipf:
        ids = ((rng.zipf(1.3, size=(B, F)) - 1) % V).astype(np.int32)
    ids[rng.random((B, F)) < 0.25] = INVALID
    ids[0, :3] = [V, V + 5, 2 * V]                       # clipped to V - 1
    ids[1, :] = ids[1, 0] if ids[1, 0] >= 0 else 3      # one row, F times
    g = rng.normal(size=(B, E)).astype(np.float32)
    return table, ids, w, g


def _jax_vjp(table, ids, w, g, combiner="sum"):
    """(grad_w or None, grad_table) of JAX's embedding_bag_fixed."""
    if w is None:
        f = lambda t: jeb.embedding_bag_fixed(t, jnp.asarray(ids), None,
                                              combiner)
        _, vjp = jax.vjp(f, jnp.asarray(table))
        (gt,) = vjp(jnp.asarray(g))
        return None, np.asarray(gt)
    f = lambda t, ww: jeb.embedding_bag_fixed(t, jnp.asarray(ids), ww,
                                              combiner)
    _, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(w))
    gt, gw = vjp(jnp.asarray(g))
    return np.asarray(gw), np.asarray(gt)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("V,E,B,F,zipf", [
    pytest.param(50, 8, 6, 9, False, id="50-8-6-9"),
    pytest.param(37, 7, 5, 12, False, id="37-7-5-12"),
    pytest.param(400, 18, 16, 100, True, id="din-zipf"),
])
def test_bag_lookup_bwd_plain_matches_jax_vjp(V, E, B, F, zipf, weighted):
    table, ids, w, g = _bwd_inputs(V, E, B, F, V + F, zipf)
    w = w if weighted else None
    gw, gt = bag_ops.bag_lookup_bwd(T(table), T(ids),
                                    None if w is None else T(w), T(g))
    want_w, want_t = _jax_vjp(table, ids, w, g)
    mag_w, mag_t = _magnitudes(table, ids, w, g)
    assert gt.dtype == torch.float32 and gt.shape == (V, E)
    assert gw.dtype == torch.float32 and gw.shape == (B, F)
    _assert_grad(gt, want_t, mag_t, "grad_table")
    if w is not None:
        _assert_grad(gw, want_w, mag_w, "grad_w")
    # an invalid id's entry has no weight gradient and its row no share
    assert not gw.numpy()[ids < 0].any()
    untouched = np.setdiff1d(np.arange(V), np.clip(ids[ids >= 0], 0, V - 1))
    assert not gt.numpy()[untouched].any()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_fixed_gradient_matches_jax(combiner, weighted):
    """Through the autograd Function (the mean divides under torch's
    autograd), against jax.vjp of JAX's embedding_bag_fixed."""
    table, ids, w, g = _bwd_inputs(60, 10, 7, 8, 21)
    ids[2, :] = INVALID                                  # mean over nothing
    w = w if weighted else None
    t = T(table).requires_grad_()
    tw = None if w is None else T(w).requires_grad_()
    out = teb.embedding_bag_fixed(t, T(ids), tw, combiner)
    out.backward(T(g))
    want_w, want_t = _jax_vjp(table, ids, w, g, combiner)
    mag_w, mag_t = _magnitudes(table, ids, w, g, combiner)
    _assert_grad(t.grad, want_t, mag_t, "grad_table")
    if w is not None:
        _assert_grad(tw.grad, want_w, mag_w, "grad_w")


def test_bag_lookup_function_gradcheck_in_float64(monkeypatch):
    """``torch.autograd.gradcheck`` of the Function in float64 on a tiny
    shape.  The wrappers compute in float32, as the JAX wrapper does; here
    they are routed to the plain versions in the inputs' float64, so the
    check holds the backward's formula and the Function's plumbing (the
    gradient order, the ids' None, the masks) to finite differences."""
    def fwd(table, ids, weights):
        V = table.shape[0]
        w = torch.ones(ids.shape, dtype=table.dtype) if weights is None \
            else weights
        w = torch.where(ids < 0, 0.0, w)
        return (table[ids.clamp(0, V - 1).long()] * w[..., None]).sum(1)

    def bwd(table, ids, weights, g, need_w=True, need_table=True):
        gw, gt = bag_ops.bag_lookup_bwd_ref(table, ids, weights, g)
        return gw if need_w else None, gt if need_table else None

    monkeypatch.setattr(bag_ops, "bag_lookup", fwd)
    monkeypatch.setattr(bag_ops, "bag_lookup_bwd", bwd)
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(6, 3)), requires_grad=True)
    ids = torch.tensor([[0, 5, -1, 2], [5, 5, 9, -1], [1, 3, 3, 0]],
                       dtype=torch.int32)
    w = torch.tensor(rng.uniform(0.5, 1.5, size=(3, 4)), requires_grad=True)
    assert torch.autograd.gradcheck(teb.BagLookup.apply, (table, ids, w))
    assert torch.autograd.gradcheck(
        lambda t: teb.BagLookup.apply(t, ids, None), (table,))


def test_bag_lookup_bwd_on_the_cpu_launches_nothing():
    table, ids, w, g = _bwd_inputs(30, 6, 4, 5, 11)
    before = bag_ops.launches_bwd
    a = bag_ops.bag_lookup_bwd(T(table), T(ids), T(w), T(g))
    b = bag_ops.bag_lookup_bwd(T(table), T(ids), T(w), T(g), impl="ref")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    gw, gt = bag_ops.bag_lookup_bwd(T(table), T(ids), T(w), T(g),
                                    need_w=False)
    assert gw is None and torch.equal(gt, a[1])
    assert bag_ops.launches_bwd == before


def test_bag_lookup_bwd_rejects_what_the_kernel_does_not_take():
    table, ids = torch.zeros((4, 8)), torch.zeros((2, 3), dtype=torch.int32)
    g = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="g "):
        bag_ops.bag_lookup_bwd(table, ids, None, torch.zeros((2, 7)))
    with pytest.raises(ValueError):                      # int64 ids
        bag_ops.bag_lookup_bwd(table, ids.long(), None, g)
    with pytest.raises(ValueError):                      # weights' shape
        bag_ops.bag_lookup_bwd(table, ids, torch.ones((3, 2)), g)
    with pytest.raises(ValueError, match="impl"):
        bag_ops.bag_lookup_bwd(table, ids, None, g, impl="triton")


def _kernel_model(V, E, ids, w, g, G, chunk, combine=1024):
    """``csrc/bag_lookup_bwd.cu``'s order in float32 numpy, from the
    ids' order (``bwd_order``): each sorted entry's contribution G[e] +
    w[e] * g[b] (a float32 multiply, then a float32 add); the chunk pass (a
    row's run within a chunk added in order, a row wholly inside the chunk
    written straight out, a row across the chunk's start leaving a partial
    in slot 0, one across its end in slot 1) and the combine pass (the
    chunk where a crossing row starts adds its partials: K = combine // E
    groups, group k the partials k, k + K, ... in turn, then the groups in
    order); a memset's zeros on every other row.  The float32 operations
    are the kernel's, in its order."""
    order, _ = bag_ops.bwd_order(T(np.zeros((V, E), np.float32)), T(ids),
                                 None if w is None else T(w))
    n = int(order.count)
    keys, pos = order.keys.numpy(), order.pos.numpy()
    B, F = ids.shape
    c = np.zeros((n, E), np.float32) if G is None else \
        G.reshape(-1, E)[pos].astype(np.float32)
    ws = np.ones(n, np.float32) if w is None else order.w.numpy()
    c = c + ws[:, None] * g[pos // F]
    assert c.dtype == np.float32
    out = np.zeros((V, E), np.float32)
    written = np.zeros(V, bool)
    n_chunks = -(-n // chunk)
    partial = np.full((n_chunks, 2, E), np.nan, np.float32)

    def write(row, acc):
        assert not written[row]                     # each row written once
        written[row] = True
        out[row] = acc

    for ci in range(n_chunks):
        lo, hi = ci * chunk, min(ci * chunk + chunk, n)
        first_starts = lo == 0 or keys[lo - 1] != keys[lo]
        last_ends = hi == n or keys[hi] != keys[hi - 1]

        def flush(row, seg, ends_in, acc):
            if (seg > lo or first_starts) and ends_in:
                write(row, acc)
            else:
                partial[ci, 0 if seg == lo else 1] = acc

        row, seg, acc = keys[lo], lo, np.zeros(E, np.float32)
        for j in range(lo, hi):
            if keys[j] != row:
                flush(row, seg, True, acc)
                row, seg, acc = keys[j], j, np.zeros(E, np.float32)
            acc = acc + c[j]
        flush(row, seg, last_ends, acc)
    K = combine // E
    for c0 in range(n_chunks):
        lo, hi = c0 * chunk, min(c0 * chunk + chunk, n)
        if hi == n or keys[hi] != keys[hi - 1]:
            continue
        r = keys[hi - 1]
        at_lo = keys[lo] == r
        if at_lo and lo > 0 and keys[lo - 1] == r:
            continue
        m = (np.searchsorted(keys, r, side="right") - 1) // chunk - c0 + 1
        red = []
        for k in range(K):
            s = np.zeros(E, np.float32)
            for i in range(k, m, K):
                s = s + partial[c0 + i, (0 if at_lo else 1) if i == 0 else 0]
            red.append(s)
        t = red[0]
        for q in range(1, K):
            t = t + red[q]
        write(r, t)
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("with_G", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 8, 64, 4096])
@pytest.mark.parametrize("weighted", [True, False])
def test_kernel_order_model_matches_the_plain_grad_table(chunk, weighted,
                                                         with_G):
    """The sorted, chunked order of ``csrc/bag_lookup_bwd.cu`` (modelled
    in numpy: the kernel itself runs only on a card) gives the plain
    version's ``grad_table`` at every chunk size, rows crossing one and
    many chunk edges and the Zipf head among them, with the history's
    cotangent G and without.  The sums are taken in another order, so to
    float32 rounding (rtol 1e-5 / atol 1e-6, the tolerance
    ``chip_smoke.py`` holds the kernel to)."""
    table, ids, w, g = _bwd_inputs(40, 5, 12, 9, 31, zipf=True)
    G = np.random.default_rng(4).normal(size=ids.shape + (5,)).astype(
        np.float32) if with_G else None
    w = w if weighted else None
    got = _kernel_model(40, 5, ids, w, g, G, chunk)
    _, want = bag_ops.bag_lookup_bwd(T(table), T(ids),
                                     None if w is None else T(w), T(g),
                                     G=None if G is None else T(G))
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


def test_bwd_order_sorts_by_row_stably_invalid_last():
    """The plain order: the valid entries by key ``clip(id, max=V-1)``,
    stably, their positions and weights alongside; every invalid entry is
    left out (past ``count``, where the kernel's slots are unused)."""
    ids = torch.tensor([[3, -1, 3, 9], [0, 3, 12, -1]], dtype=torch.int32)
    w = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    order, _ = bag_ops.bwd_order(torch.zeros((10, 2)), ids, w)
    assert order.keys.dtype == order.pos.dtype == torch.int32
    assert order.keys.tolist() == [0, 3, 3, 3, 9, 9]
    assert order.pos.tolist() == [4, 0, 2, 5, 3, 6]
    assert order.w.tolist() == [4.0, 0.0, 2.0, 5.0, 3.0, 6.0]
    assert order.count.tolist() == [6]
    bare, grad_w = bag_ops.bwd_order(torch.zeros((10, 2)), ids)
    assert bare.w is None and grad_w is None
    assert torch.equal(bare.pos, order.pos)
