"""The Alg. 3 selection pass (``kernels/extend_select``): its plain version
against the JAX package's ``extend_wave_device``, the two-step path it
replaces, the routing of ``core/extend.py::extend_wave_device``, and the
wrapper's checks.

The operands are an extend block over a graph the port builds (400 x 16,
degree 8), made with numpy from a seed: 16 lanes that pretend to be the
vertices after the graph's last, each with its candidate search on the
graph.  The block holds every case the pass distinguishes: INVALID-padded
candidates (lane 3 keeps 3, and fails), a lane with no candidate (lane 7,
fails at once), candidates at or above the lane's own id (lane 5 takes an
id below most of its candidates, which become ineligible), and the
phase-2 latch (lane 9: its first candidate is made the first neighbor of
each of its others, whose distances are doubled, so that once the first
joins U the lune test blocks every other).  The last block of a build
has fewer than 16 lanes (6 here).

Against JAX: ``sel_ids`` and ``ok`` exactly, ``sel_dists`` at rtol 1e-6
(the lune test's distances are summed in another order), for schemes A-D
with and without the Alg. 2 check, under the jnp backend and with the
``mrng_occlusion`` Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.extend import extend_wave_device as j_extend_wave_device
from repro_torch.core import extend
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.kernels.extend_select import ops as es_ops
from repro_torch.kernels.extend_select import ref as es_ref
from repro_torch.kernels.mrng_occlusion import ops as occ_ops
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
N, DIM, DEGREE, K = 400, 16, 8, 16
NAMES = ("adjacency", "weights", "vectors", "cand_ids", "cand_dists",
         "queries", "v_ids")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(N, DIM)).astype(np.float32)
    return build_deg(base, DEGParams(degree=DEGREE, k_ext=K, eps_ext=0.2),
                     wave_size=64, device="cpu")


def _block(index, W, seed=0):
    """An extend block of W lanes as numpy operands (see the module
    docstring for the cases it holds when W = 16)."""
    rng = np.random.default_rng(seed)
    g = index.frozen()
    adj = g.adjacency.numpy().copy()
    vectors = index._dev_vectors.numpy()
    pts = (vectors[rng.integers(0, N, W)]
           + 0.2 * rng.normal(size=(W, DIM))).astype(np.float32)
    res = index.search_batch(pts, np.zeros((W, 1), np.int32), k=K, eps=0.2)
    ids = res.ids.numpy().copy()
    dists = res.dists.numpy().copy()
    v_ids = np.arange(N, N + W, dtype=np.int32)
    if W == 16:
        ids[3, 3:] = INVALID
        dists[3, 3:] = np.inf
        ids[7] = INVALID
        dists[7] = np.inf
        v_ids[5] = np.sort(ids[5])[K // 4]
        adj[ids[9, 1:]] = np.where(np.arange(DEGREE) == 0, ids[9, 0],
                                   adj[ids[9, 1:]])
        dists[9] *= 2
    # the weights of the rows the candidates name: their true distances
    weights = g.weights.numpy().copy()
    rows = np.unique(ids[ids != INVALID])
    nbr = np.clip(adj[rows], 0, N - 1)
    weights[rows] = np.linalg.norm(vectors[rows][:, None, :] - vectors[nbr],
                                   axis=-1)
    return dict(adjacency=adj, weights=weights.astype(np.float32),
                vectors=vectors, cand_ids=ids, cand_dists=dists,
                queries=pts, v_ids=v_ids)


@pytest.fixture(scope="module")
def blocks(index):
    return {16: _block(index, 16), 6: _block(index, 6, seed=1)}


def _t(op):
    return [torch.from_numpy(np.asarray(op[k])) for k in NAMES]


CASES = [(W, scheme, rng_checks, backend) for W in (16, 6)
         for scheme in es_ref.SCHEMES for rng_checks in (True, False)
         for backend in ("jnp", "pallas")]


@pytest.mark.parametrize("W, scheme, rng_checks, backend", CASES)
def test_plain_equals_jax_extend_wave_device(blocks, W, scheme, rng_checks,
                                             backend):
    """The wrapper on the CPU (its plain version) against JAX's
    ``extend_wave_device`` on the same operands."""
    op = blocks[W]
    want = j_extend_wave_device(*(jnp.asarray(op[k]) for k in NAMES),
                                scheme=scheme, rng_checks=rng_checks,
                                backend=backend)
    got = es_ops.extend_select(*_t(op), scheme=scheme, rng_checks=rng_checks)
    sel_ids, sel_d, ok = (x.numpy() for x in got)
    np.testing.assert_array_equal(sel_ids, np.asarray(want[0]))
    np.testing.assert_array_equal(ok, np.asarray(want[2]))
    np.testing.assert_allclose(sel_d, np.asarray(want[1]), rtol=1e-6)
    # every selected candidate b lies below its lane's vertex
    assert (sel_ids[ok][:, 0::2] < op["v_ids"][ok, None]).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip", "cos"])
def test_plain_equals_jax_under_other_metrics(blocks, metric):
    """The lune test under squared l2 (the kernel's other metric) and the
    two metrics that take the plain version on every device.  An inner
    product is a sum of terms of both signs, so its relative error grows
    where they cancel: ip and cos distances are held at rtol 1e-6 plus
    atol 1e-6 (an ulp of the products' magnitudes here), squared l2 at
    rtol 1e-6."""
    op = blocks[16]
    want = j_extend_wave_device(*(jnp.asarray(op[k]) for k in NAMES),
                                metric=metric)
    got = es_ops.extend_select(*_t(op), metric=metric)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6,
                               atol=0 if metric == "sqeuclidean" else 1e-6)


def test_block_holds_failed_lanes_ineligible_candidates_and_the_latch(
        blocks):
    """The 16-lane block reaches every case: lanes 3 and 7 fail, lane 5
    selects only candidates below its id, lane 9 latches (and the lanes of
    an unmodified search do not, with the Alg. 2 check on), and without
    the check every lane starts latched."""
    op = blocks[16]
    sel_ids, _, ok, latched = es_ref.extend_select_latched(*_t(op))
    assert not ok[3] and not ok[7] and int(ok.sum()) == 14
    assert bool((sel_ids[7] == INVALID).all())
    assert int((sel_ids[3] != INVALID).sum()) < DEGREE
    assert (sel_ids[5, 0::2][ok[5].expand(DEGREE // 2)]
            < op["v_ids"][5]).all()
    assert bool(latched[9]) and not bool(latched[0])
    *_, latched_off = es_ref.extend_select_latched(*_t(op), rng_checks=False)
    assert bool(latched_off.all())


@pytest.mark.parametrize("scheme", es_ref.SCHEMES)
def test_two_step_path_equals_the_plain_version(blocks, scheme):
    """The path the kernel replaces on the card (the ``mrng_occlusion``
    wrapper, then the selection steps) is the plain version on the CPU,
    where that wrapper takes ``mrng_occlusion_ref``."""
    args = _t(blocks[16])
    want = es_ops.extend_select(*args, scheme=scheme)
    got = es_ref.extend_select_ref(*args, scheme=scheme,
                                   occlusion=occ_ops.mrng_occlusion)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_extend_wave_device_calls_the_wrapper_once(blocks, monkeypatch):
    """``extend_wave_device`` hands the whole block to ``extend_select``
    in one call (on the card one launch) and reaches no
    ``mrng_occlusion``."""
    calls = []
    inner = es_ops.extend_select

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("mrng_occlusion reached beside extend_select")

    args = _t(blocks[16])
    want = es_ref.extend_select_ref(*args, scheme="B", rng_checks=False)
    monkeypatch.setattr(es_ops, "extend_select", spy)
    monkeypatch.setattr(occ_ops, "mrng_occlusion", refuse)
    got = extend.extend_wave_device(*args, scheme="B", rng_checks=False)
    assert calls == [dict(scheme="B", rng_checks=False, metric="l2")]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("metric, K, D, m, want", [
    ("l2", 40, 20, 192, True), ("sqeuclidean", 60, 30, 128, True),
    ("ip", 40, 20, 192, False), ("cos", 40, 20, 192, False),
    ("l2", 40, 64, 192, True), ("l2", 40, 65, 192, False),
    ("l2", 0, 20, 192, False), ("l2", 2000, 20, 192, False)])
def test_kernel_takes(metric, K, D, m, want):
    """The kernel takes l2 and sqeuclidean on a CUDA device, a degree of at
    most 64 (its neighbor masks are 64-bit) and a layout within 227 KB;
    ``extend_wave_device`` sends everything else to the two-step path."""
    assert es_ops.kernel_takes("cuda", metric, K, D, m) == want
    assert not es_ops.kernel_takes("cpu", metric, K, D, m)
    if metric == "l2" and K == 2000:
        assert es_ops.smem_bytes(m, K, D) > es_ops.MAX_SMEM


def test_smem_bytes_and_cluster_at_the_audio_block():
    """K = 40, d = 20, m = 192: the query, 40 candidates, 800 gathered
    neighbors at 13 bytes, three 64-bit masks and two flags a candidate,
    20 selections; each section rounded up to 16 bytes.  8 CTAs a lane."""
    assert es_ops.smem_bytes(192, 40, 20) == (
        768 + 160 + 160 + 3 * 3200 + 800 + 3 * 320 + 48 + 48 + 80 + 80)
    assert es_ops.cluster_size(40) == 8 and es_ops.cluster_size(3) == 3
    assert es_ops.cluster_size(1) == 1


def _bad(**change):
    op = dict(zip(NAMES, [torch.zeros((10, 4), dtype=torch.int32),
                          torch.zeros((10, 4)), torch.zeros((10, 8)),
                          torch.zeros((2, 5), dtype=torch.int32),
                          torch.zeros((2, 5)), torch.zeros((2, 8)),
                          torch.zeros((2,), dtype=torch.int32)]))
    op.update(change)
    return [op[k] for k in NAMES]


BAD = {
    "adjacency int64": dict(adjacency=torch.zeros((10, 4),
                                                  dtype=torch.int64)),
    "weights float64": dict(weights=torch.zeros((10, 4),
                                                dtype=torch.float64)),
    "weights shape": dict(weights=torch.zeros((10, 3))),
    "vectors float16": dict(vectors=torch.zeros((10, 8),
                                                dtype=torch.float16)),
    "cand_ids int64": dict(cand_ids=torch.zeros((2, 5), dtype=torch.int64)),
    "cand_dists shape": dict(cand_dists=torch.zeros((2, 4))),
    "queries width": dict(queries=torch.zeros((2, 7))),
    "v_ids lanes": dict(v_ids=torch.zeros((3,), dtype=torch.int32)),
    "cand_ids 1-D": dict(cand_ids=torch.zeros((5,), dtype=torch.int32)),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_rejects_bad_operands(bad):
    """Types and shapes are checked before either version runs; the good
    operands pass."""
    sel_ids, _, ok = es_ops.extend_select(*_bad())
    assert sel_ids.shape == (2, 4) and ok.shape == (2,)
    with pytest.raises(ValueError):
        es_ops.extend_select(*_bad(**BAD[bad]))


def test_wrapper_rejects_an_unknown_scheme_and_impl():
    with pytest.raises(ValueError, match="scheme"):
        es_ops.extend_select(*_bad(), scheme="E")
    with pytest.raises(ValueError, match="impl"):
        es_ops.extend_select(*_bad(), impl="cuda")


def test_device_build_goes_through_the_selection_pass(index, monkeypatch):
    """A device-extend build calls ``extend_select`` once an extend block
    and builds the graph of the build without the spy."""
    calls = []
    inner = es_ops.extend_select

    def spy(*a, **k):
        calls.append(a[3].shape[0])
        return inner(*a, **k)

    monkeypatch.setattr(es_ops, "extend_select", spy)
    vecs = index._dev_vectors.numpy()[:120]
    params = DEGParams(degree=DEGREE, k_ext=K, eps_ext=0.2)
    got = build_deg(vecs, params, wave_size=64, device="cpu")
    monkeypatch.undo()
    want = build_deg(vecs, params, wave_size=64, device="cpu")
    np.testing.assert_array_equal(got.builder.adjacency,
                                  want.builder.adjacency)
    # 111 vertices in waves of 64, each cut into blocks of extend_block
    assert params.extend_block == 16
    assert calls == [16] * 4 + [16, 16, 15]


def test_wrapper_raises_off_the_cpu_without_a_card():
    """A tensor on a device that is neither the CPU nor CUDA takes no
    fallback: the wrapper raises."""
    ops = [x.to("meta") for x in _bad()]
    with pytest.raises(ValueError, match="the kernel takes"):
        es_ops.extend_select(*ops)
