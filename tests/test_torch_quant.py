"""The port's compressed-store codecs and the plain versions of its two
new kernels against the JAX package.

* sq8 scales and codes, fp16 codes: bit for bit (``torch.round`` and
  ``jnp.round`` both round half to even).
* ``pq.fit``: byte-identical codebooks (the same numpy code).
* ``pq.encode``: equal codes on every row whose best and second-best
  sub-distances differ by more than 1e-5 relative (the two frameworks
  may round the expanded ``sn - 2 cross + cn`` differently in the last
  ulp, which can only swap a near tie).
* ``gather_dist_q`` and ``pq_adc`` (plain versions) against the JAX
  kernels in interpret mode and their oracles at rtol 1e-5, atol 1e-6
  (the frameworks sum the m squares, or the m_sub table entries, in
  different orders); ``gather_dist`` on fp16 and bf16 rows at rtol 1e-6.
* Dimensions where ``dim % 8 != 0`` give pq subspaces of 4, 2 and 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_dist import ops as jgd_ops
from repro.kernels.gather_dist_q import gather_dist_q as j_gather_dist_q
from repro.kernels.gather_dist_q import gather_dist_q_ref as j_gdq_ref
from repro.kernels.pq_adc import pq_adc as j_pq_adc
from repro.quant import codec as jcodec
from repro.quant import pq as jpq
from repro.quant import store as jstore
from repro_torch.interop import store_from_numpy, store_to_numpy
from repro_torch.kernels.gather_dist import ops as gd_ops
from repro_torch.kernels.gather_dist_q import ops as gdq_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.quant import codec, pq
from repro_torch.quant.store import VectorStore, as_store, make_store
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
T = torch.tensor          # a copy: arrays from JAX are read-only
CODECS = ["float32", "fp16", "sq8", "pq"]


def _rows(seed, n, m, spread=1.0):
    rng = np.random.default_rng(seed)
    return rng, (spread * rng.normal(size=(n, m))).astype(np.float32)


# ------------------------------------------------------------------ codecs --
@pytest.mark.parametrize("n,m,live,spread", [
    (50, 16, None, 1.0), (64, 33, 40, 20.0), (200, 192, 150, 0.05),
    (7, 5, 3, 300.0)])
def test_sq8_scale_and_codes_bit_exact(n, m, live, spread):
    _, x = _rows(n + m, n, m, spread)
    x[-1] *= 1000.0 if live else 1.0       # padding must not move the scale
    scale = codec.calibrate_sq8_scale(T(x), live)
    jscale = np.asarray(jcodec.calibrate_sq8_scale(jnp.asarray(x), live))
    np.testing.assert_array_equal(scale.numpy(), jscale)
    codes = codec.sq8_encode(T(x), scale).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(jcodec.sq8_encode(jnp.asarray(x),
                                            jnp.asarray(jscale))))
    back = codec.sq8_decode(T(codes), scale).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jcodec.sq8_decode(jnp.asarray(codes),
                                           jnp.asarray(jscale))))


def test_sq8_rounds_half_to_even_as_jax():
    """Values on exact .5 boundaries of the code grid."""
    scale = np.full((6,), 0.5, np.float32)
    x = np.array([[0.25, 0.75, -0.25, -0.75, 1.25, 63.75]], np.float32)
    got = codec.sq8_encode(T(x), T(scale)).numpy()
    want = np.asarray(jcodec.sq8_encode(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [0, 2, 0, -2, 2, 127])


@pytest.mark.parametrize("n,m", [(40, 8), (33, 17)])
def test_fp16_codes_bit_exact(n, m):
    _, x = _rows(n, n, m, 30.0)
    got = make_store(T(x), "fp16", n=None).data.numpy()
    want = np.asarray(jstore.make_store(x, "fp16", n=None).data)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("codec_name", ["float32", "fp16", "sq8", "pq"])
@pytest.mark.parametrize("dim", [8, 12, 6, 7, 192])
def test_store_bytes_match(codec_name, dim):
    for n_rows in (0, 1, 53_387):
        assert (codec.store_bytes(codec_name, n_rows, dim)
                == jcodec.store_bytes(codec_name, n_rows, dim))
    assert (codec.bytes_per_row(codec_name, dim)
            == jcodec.bytes_per_row(codec_name, dim))


def test_unknown_codec_raises():
    x = torch.zeros((4, 2))
    for call in (lambda: codec.encode("int4", x, None),
                 lambda: codec.decode("int4", x, None),
                 lambda: codec.bytes_per_row("int4", 2),
                 lambda: make_store(x, "int4", n=None),
                 lambda: VectorStore(x, codec="int4")):
        with pytest.raises(ValueError, match="unknown codec"):
            call()


def test_make_store_requires_live_count():
    with pytest.raises(TypeError):
        make_store(torch.zeros((4, 2)), "sq8")


# ---------------------------------------------------------------------- pq --
@pytest.mark.parametrize("n,dim,live,seed", [
    (300, 16, None, 0),      # dsub 8
    (120, 8, 100, 3),        # fewer rows than centroids
    (260, 12, 255, 1),       # dsub 4
    (200, 6, None, 2),       # dsub 2
    (150, 7, 140, 5)])       # dsub 1
def test_pq_fit_codebooks_byte_identical(n, dim, live, seed):
    _, x = _rows(seed, n, dim, 3.0)
    got = pq.fit(x, live, seed=seed, iters=10)
    want = jpq.fit(x, live, seed=seed, iters=10)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert pq.subspace_dim(dim) == jpq.subspace_dim(dim)
    assert pq.n_subspaces(dim) == jpq.n_subspaces(dim)


def _margin_rows(x, books):
    """Rows whose best and second-best centroid differ by more than 1e-5
    (relative) in every subspace, by float64 distances.  Copies of the
    best centroid (a fit on fewer than 256 rows tiles its rows) tie
    exactly in both frameworks, where the first wins, so they are not a
    second best."""
    m_sub, _, dsub = books.shape
    sub = x.astype(np.float64).reshape(len(x), m_sub, dsub)
    d2 = ((sub[:, :, None, :] - books.astype(np.float64)[None]) ** 2).sum(-1)
    best = np.argmin(d2, axis=-1)                        # (n, m_sub)
    best_c = books[np.arange(m_sub)[None, :], best]      # (n, m_sub, dsub)
    copy = (books[None] == best_c[:, :, None, :]).all(-1)
    d_best = np.take_along_axis(d2, best[..., None], -1)[..., 0]
    d_second = np.where(copy, np.inf, d2).min(axis=-1)
    gap = d_second - d_best
    return (gap > 1e-5 * np.maximum(d_second, 1e-30)).all(axis=1)


@pytest.mark.parametrize("n,dim", [(600, 16), (400, 12), (300, 6), (300, 7),
                                   (500, 192)])
def test_pq_encode_codes_match(n, dim):
    _, x = _rows(n + dim, n, dim)
    books = jpq.fit(x[: n // 2], None, seed=0, iters=8)
    got = pq.encode(T(x), T(books)).numpy()
    want = np.asarray(jpq.encode(x, books))
    assert got.dtype == np.uint8
    clear = _margin_rows(x, books)
    assert clear.mean() == 1.0, "a row with a near tie (none expected at these seeds)"
    np.testing.assert_array_equal(got[clear], want[clear])


def test_pq_encode_takes_the_first_of_equal_centroids():
    books = np.zeros((1, 256, 2), np.float32)
    books[0, 5] = books[0, 9] = [1.0, 1.0]    # two equal nearest centroids
    books[0, :5] = books[0, 10:] = 50.0
    books[0, 6:9] = 50.0
    x = np.array([[1.0, 1.0], [0.9, 1.1]], np.float32)
    got = pq.encode(T(x), T(books)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpq.encode(x, books)))
    np.testing.assert_array_equal(got[:, 0], [5, 5])


@pytest.mark.parametrize("dim", [16, 12, 6, 7])
def test_pq_decode_and_lut_match(dim):
    rng, x = _rows(dim, 300, dim)
    books = jpq.fit(x, None, seed=1, iters=5)
    codes = np.asarray(jpq.encode(x, books))
    np.testing.assert_array_equal(
        pq.decode(T(codes), T(books)).numpy(),
        np.asarray(jpq.decode(jnp.asarray(codes), books)))
    q = rng.normal(size=(5, dim)).astype(np.float32)
    np.testing.assert_allclose(
        pq.adc_lut(T(q), T(books)).numpy(),
        np.asarray(jpq.adc_lut(jnp.asarray(q), books)), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ store ---
@pytest.mark.parametrize("codec_name", CODECS)
def test_make_store_matches_jax(codec_name):
    _, x = _rows(11, 300, 12, 2.0)
    live = 280
    got = store_to_numpy(make_store(T(x), codec_name, n=live))
    want = jstore.make_store(x, codec_name, n=live)
    assert got["codec"] == want.codec
    if codec_name == "pq":
        np.testing.assert_array_equal(got["codebooks"],
                                      np.asarray(want.codebooks))
        clear = _margin_rows(x, got["codebooks"])
        np.testing.assert_array_equal(got["data"][clear],
                                      np.asarray(want.data)[clear])
    else:
        np.testing.assert_array_equal(got["data"], np.asarray(want.data))
    np.testing.assert_array_equal(got["scale"], np.asarray(want.scale))


@pytest.mark.parametrize("codec_name", CODECS)
def test_store_decode_clips_and_matches_jax(codec_name):
    """INVALID (-1) and out-of-range ids read row 0 and the last row, as
    in the JAX store; the poisoned last row shows where an id wrapped."""
    _, x = _rows(21, 50, 16)
    x[-1] = 1e3
    jst = jstore.make_store(x, codec_name, n=None)
    st = store_from_numpy(jst.data, jst.scale, codec_name,
                          None if jst.codebooks is None else jst.codebooks,
                          device="cpu")
    ids = np.array([[-1, 3, 49, 50, 1000], [0, -1, 7, -1, 2]], np.int32)
    got = st.decode(T(ids)).numpy()
    want = np.asarray(jst.decode(jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], got[1, 0])
    assert st.exact == jst.exact and st.dim == jst.dim == 16
    assert st.capacity == jst.capacity


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("rows", [None, 37])
def test_memory_bytes_match(codec_name, rows):
    _, x = _rows(5, 100, 24)
    got = make_store(T(x), codec_name, n=None).memory_bytes(rows)
    want = jstore.make_store(x, codec_name, n=None).memory_bytes(rows)
    assert got == want


def test_store_refuses_mismatched_state():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="codebooks"):
        VectorStore(x.to(torch.uint8), codec="pq")
    with pytest.raises(ValueError, match="scale"):
        VectorStore(x.to(torch.int8), codec="sq8")
    with pytest.raises(ValueError, match="scale"):
        VectorStore(x, scale=torch.ones(8))
    assert as_store(x).exact and as_store(as_store(x)).exact


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_neighbor_distances_match_jax_decode_route(codec_name, metric):
    """The store's distances (the kernels' plain versions for l2 and
    sqeuclidean, decode + pair otherwise) against the JAX store's jnp
    route, which decodes and applies the metric's pair."""
    rng, x = _rows(31, 80, 12)
    jst = jstore.make_store(x, codec_name, n=None)
    st = store_from_numpy(jst.data, jst.scale, codec_name, jst.codebooks,
                          device="cpu")
    q = rng.normal(size=(4, 12)).astype(np.float32)
    ids = rng.integers(0, 80, size=(4, 9)).astype(np.int32)
    got = st.neighbor_distances(T(q), T(ids), metric).numpy()
    want = np.asarray(jst.neighbor_distances(jnp.asarray(q),
                                             jnp.asarray(ids), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- kernels' plain versions --
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("N,m,B,d", [(100, 33, 2, 7), (256, 128, 4, 16),
                                     (300, 192, 3, 20), (60, 6, 2, 5)])
def test_gather_dist_q_plain_matches_jax(N, m, B, d, squared):
    rng, x = _rows(N + m, N, m)
    jst = jstore.make_store(x, "sq8", n=None)
    codes, scale = np.asarray(jst.data), np.asarray(jst.scale)
    q = rng.normal(size=(B, m)).astype(np.float32)
    ids = rng.integers(0, N, size=(B, d)).astype(np.int32)
    ids[0, :3] = [INVALID, N, N + 9]          # clipped, as the JAX wrapper
    got = gdq_ops.gather_dist_q(T(codes), T(scale), T(ids), T(q),
                                squared=squared).numpy()
    want = np.asarray(j_gather_dist_q(jnp.asarray(codes), jnp.asarray(scale),
                                      jnp.asarray(ids), jnp.asarray(q),
                                      squared=squared, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    safe = np.clip(ids, 0, N - 1)
    oracle = np.asarray(j_gdq_ref(jnp.asarray(codes), jnp.asarray(scale),
                                  jnp.asarray(safe), jnp.asarray(q),
                                  squared=squared))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("N,dim,B,d", [(100, 24, 2, 7), (256, 32, 3, 12),
                                       (300, 12, 2, 9), (200, 6, 2, 8),
                                       (120, 7, 2, 6), (400, 192, 2, 20)])
def test_pq_adc_plain_matches_jax(N, dim, B, d, squared):
    """Against the JAX kernel in interpret mode, and against exact l2 to
    the decoded rows (ADC is exact for l2)."""
    rng, x = _rows(5 * N + dim, N, dim)
    jst = jstore.make_store(x, "pq", n=None)
    codes, books = np.asarray(jst.data), np.asarray(jst.codebooks)
    q = rng.normal(size=(B, dim)).astype(np.float32)
    ids = rng.integers(0, N, size=(B, d)).astype(np.int32)
    ids[0, :3] = [INVALID, N, N + 4]
    got = adc_ops.pq_adc(T(codes), T(books), T(ids), T(q),
                         squared=squared).numpy()
    want = np.asarray(j_pq_adc(jnp.asarray(codes), jnp.asarray(books),
                               jnp.asarray(ids), jnp.asarray(q),
                               squared=squared, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    dec = pq.decode(T(codes[np.clip(ids, 0, N - 1)]), T(books)).numpy()
    d2 = ((dec - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, d2 if squared else np.sqrt(d2),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("half", ["float16", "bfloat16"])
@pytest.mark.parametrize("N,m,B,d", [(100, 33, 3, 9), (300, 192, 2, 20),
                                     (64, 12, 2, 5)])
def test_gather_dist_half_rows_match_jax(N, m, B, d, half, squared):
    rng, x = _rows(N + m + len(half), N, m)
    jrows = jnp.asarray(x, getattr(jnp, half))
    rows = T(np.asarray(jrows.astype(jnp.float32))).to(getattr(torch, half))
    q = rng.normal(size=(B, m)).astype(np.float32)
    ids = rng.integers(0, N, size=(B, d)).astype(np.int32)
    ids[0, :2] = [INVALID, N + 2]
    got = gd_ops.gather_dist(rows, T(ids), T(q), squared=squared).numpy()
    want = np.asarray(jgd_ops.gather_dist(jrows, jnp.asarray(ids),
                                          jnp.asarray(q), squared=squared,
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    codes = torch.zeros((8, 4), dtype=torch.int8)
    ids = torch.zeros((1, 2), dtype=torch.int32)
    q = torch.zeros((1, 4))
    with pytest.raises(TypeError):
        gdq_ops.gather_dist_q(codes.to(torch.uint8), torch.ones(4), ids, q)
    with pytest.raises(ValueError):
        gdq_ops.gather_dist_q(codes, torch.ones(3), ids, q)
    with pytest.raises(ValueError, match="impl"):
        gdq_ops.gather_dist_q(codes, torch.ones(4), ids, q, impl="fast")
    books = torch.zeros((4, 256, 1))
    with pytest.raises(TypeError):
        adc_ops.pq_adc(codes, books, ids, q)
    with pytest.raises(ValueError, match="disagree"):
        adc_ops.pq_adc(codes.to(torch.uint8), books[:3], ids, q)
    wide = torch.zeros((8, 129), dtype=torch.uint8)
    with pytest.raises(ValueError, match="129"):
        adc_ops.pq_adc(wide, torch.zeros((129, 256, 1)), ids,
                       torch.zeros((1, 129)))
    # a tensor on a device that is neither the CPU nor CUDA raises
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        gdq_ops.gather_dist_q(codes.to(**meta), torch.ones(4, **meta),
                              ids.to(**meta), q.to(**meta))
    with pytest.raises(ValueError):
        adc_ops.pq_adc(codes.to(torch.uint8).to(**meta), books.to(**meta),
                       ids.to(**meta), q.to(**meta))
