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
"""
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
