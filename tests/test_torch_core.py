"""The port's graph, metrics, store, dispatch rules and kernel build keys,
against the JAX package where it has a counterpart."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.core.build import DEGParams as JDEGParams
from repro.core.graph import complete_graph as j_complete_graph
from repro_torch.core import distances as td
from repro_torch.core.graph import INVALID, GraphBuilder, complete_graph
from repro_torch.interop import params_from_dict
from repro_torch.kernels import _build
from repro_torch.kernels.beam_merge import ops as bm_ops
from repro_torch.kernels.fused_hop import ops as fh_ops
from repro_torch.kernels.gather_dist import ops as gd_ops
from repro_torch.quant.store import VectorStore
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_metrics_match_jax(metric):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    tm, jm = td.get_metric(metric), jd.get_metric(metric)
    np.testing.assert_allclose(
        tm.cross(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(jm.cross(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tm.pair(torch.from_numpy(q)[:, None], torch.from_numpy(x)[None]).numpy(),
        np.asarray(jm.pair(jnp.asarray(q)[:, None], jnp.asarray(x)[None])),
        rtol=1e-5, atol=1e-6)


def test_exact_knn_batched_matches_jax():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(300, 16)).astype(np.float32)
    qs = rng.normal(size=(20, 16)).astype(np.float32)
    d, i = td.exact_knn_batched(qs, base, 10, tile=64, device="cpu")
    jd_, ji = jd.exact_knn_batched(jnp.asarray(qs), jnp.asarray(base), 10,
                                   tile=64)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd_), rtol=1e-5, atol=1e-5)


def test_complete_graph_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(9, 12)).astype(np.float32)
    t = complete_graph(pts, 8, 16, device="cpu")
    j = j_complete_graph(pts, 8, 16)
    np.testing.assert_array_equal(t.adjacency, j.adjacency)
    np.testing.assert_allclose(t.weights, j.weights, rtol=1e-5, atol=1e-6)
    assert t.n == j.n == 9


def test_device_twin_syncs_dirty_rows_and_full_uploads():
    b = GraphBuilder(24, 4, device="cpu")
    for _ in range(10):
        b.add_vertex()
    g0 = b.device_graph()
    b.add_edge(1, 2, 0.5)                       # 2 of 24 rows dirty: row copy
    g1 = b.device_graph()
    assert g1.adjacency is g0.adjacency          # the same buffer, in place
    np.testing.assert_array_equal(g1.adjacency.numpy(), b.adjacency)
    frozen = b.freeze()
    for u in range(3, 7):
        b.add_edge(0, u, 1.0)
    b.add_edge(7, 8, 1.0)    # rows 0, 3-8 dirty: 7 of 24, over 1/4: upload
    g2 = b.device_graph()
    assert g2.adjacency is not g1.adjacency
    np.testing.assert_array_equal(g2.adjacency.numpy(), b.adjacency)
    np.testing.assert_array_equal(g2.weights.numpy(), b.weights)
    assert (frozen.adjacency[0] == INVALID).all()  # freeze() kept its rows
    b.grow(128)
    assert b.device_graph().capacity == 128


def test_store_clips_decode_and_refuses_compressed_codecs():
    """Decode clips ids to the table; a codec the store does not know (a
    4-bit one, say) is refused."""
    data = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    s = VectorStore(data)
    got = s.decode(torch.tensor([[-1, 0, 3, 9]], dtype=torch.int32))
    np.testing.assert_array_equal(got[0, :, 0].numpy(), [0, 0, 9, 9])
    for codec in ("int4", "pq4", "float64"):
        with pytest.raises(ValueError, match="unknown codec"):
            VectorStore(data, codec=codec)


def test_wrappers_raise_off_cpu_and_off_cuda():
    """A CPU tensor takes the plain version; a tensor on any other device
    that is not CUDA raises instead of falling back."""
    meta = dict(device="meta")
    v = torch.empty((8, 4), **meta)
    ids = torch.empty((2, 3), dtype=torch.int32, **meta)
    q = torch.empty((2, 4), **meta)
    with pytest.raises(ValueError):
        gd_ops.gather_dist(v, ids, q)
    bd = torch.empty((2, 5), **meta)
    bi = torch.empty((2, 5), dtype=torch.int32, **meta)
    bb = torch.empty((2, 5), dtype=torch.bool, **meta)
    with pytest.raises(ValueError):
        bm_ops.beam_merge(bd, bi, bb, bb, bd[:, :3], bi[:, :3], bb[:, :3])
    adj = torch.empty((8, 4), dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        fh_ops.fused_hop(adj, v, ids[:, :1], q, torch.empty((2,), **meta),
                         n_valid=8)
    with pytest.raises(ValueError, match="impl"):
        gd_ops.gather_dist(v, ids, q, impl="pallas")


def test_kernel_build_keys_cover_every_source():
    assert _build.sources() == ["bag_bwd_order", "bag_lookup",
                                "bag_lookup_bwd", "beam_merge",
                                "beam_search", "extend_select", "fused_hop",
                                "gather_dist", "gather_dist_q", "l2_topk",
                                "mrng_occlusion", "pq_adc"]
    keys = {_build._target(n).name for n in _build.sources()}
    assert len(keys) == 12 and all(k.endswith(".so") for k in keys)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_params_carry_across_from_jax():
    p = params_from_dict(dataclasses.asdict(
        JDEGParams(degree=8, k_ext=16, hop_backend="pallas", expand_width=4)))
    assert (p.degree, p.k_ext, p.hop_backend, p.expand_width) == (8, 16,
                                                                  "fused", 4)
    with pytest.raises(ValueError, match="no field"):
        params_from_dict({"degree": 8, "k_ext": 16, "no_such_knob": 1})
