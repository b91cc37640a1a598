"""Each kernel's plain PyTorch version (what a CPU tensor runs, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) against the
JAX package.

* ``gather_dist``: against ``gather_dist_ref`` and against the Pallas
  kernel in interpret mode, at rtol 1e-5 (the two frameworks sum the m
  squares in different orders).
* ``beam_merge``: against ``beam_merge_ref`` and the jnp bitonic network,
  exactly, +inf ties included.
* ``fused_hop``: against ``fused_hop_ref`` (the Pallas kernel does not
  trace under the installed jax, see ROADMAP C1): ids, nbr_ids and evals
  exactly, dists at rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.beam_merge import ops as jbm_ops
from repro.kernels.beam_merge.ref import beam_merge_ref as j_beam_merge_ref
from repro.kernels.fused_hop.ref import fused_hop_ref as j_fused_hop_ref
from repro.kernels.gather_dist import ops as jgd_ops
from repro.kernels.gather_dist.ref import gather_dist_ref as j_gather_dist_ref
from repro.core import visited as jv
from repro_torch.kernels.beam_merge import ops as bm_ops
from repro_torch.kernels.fused_hop import ops as fh_ops
from repro_torch.kernels.gather_dist import ops as gd_ops
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
T = torch.from_numpy


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("N,m,B,d", [(50, 24, 6, 8), (300, 192, 4, 20)])
def test_gather_dist_plain_matches_jax(N, m, B, d, squared):
    rng = np.random.default_rng(N + m)
    vecs = rng.normal(size=(N, m)).astype(np.float32)
    qs = rng.normal(size=(B, m)).astype(np.float32)
    ids = rng.integers(0, N, size=(B, d)).astype(np.int32)
    got = gd_ops.gather_dist(T(vecs), T(ids), T(qs), squared=squared).numpy()
    want = np.asarray(j_gather_dist_ref(jnp.asarray(vecs), jnp.asarray(ids),
                                        jnp.asarray(qs), squared=squared))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # out-of-range and INVALID ids are clipped, as the JAX wrapper clips them
    ids[0, :3] = [INVALID, N, N + 7]
    got = gd_ops.gather_dist(T(vecs), T(ids), T(qs), squared=squared).numpy()
    want = np.asarray(jgd_ops.gather_dist(jnp.asarray(vecs), jnp.asarray(ids),
                                          jnp.asarray(qs), squared=squared,
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gather_dist_rejects_what_the_kernel_does_not_take():
    """float64 rows and int64 ids are refused (float32, fp16 and bf16 rows
    with int32 ids are what the kernel takes)."""
    v = torch.zeros((4, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        gd_ops.gather_dist(v, torch.zeros((1, 2), dtype=torch.int32),
                           torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        gd_ops.gather_dist(v.float(), torch.zeros((1, 2), dtype=torch.int64),
                           torch.zeros((1, 8)))


def _beam_inputs(rng, B, L, d, n_inf_beam, n_inf_cand, tie_pool):
    """Sorted beam + candidates drawn from a small value pool (many exact
    ties), with +inf tails and INVALID ids on the inf slots."""
    bd = np.sort(rng.choice(tie_pool, size=(B, L)).astype(np.float32), axis=1)
    bd[:, L - n_inf_beam:] = np.inf
    cd = rng.choice(tie_pool, size=(B, d)).astype(np.float32)
    cd[rng.random((B, d)) < n_inf_cand] = np.inf
    bi = rng.integers(0, 1000, size=(B, L)).astype(np.int32)
    ci = rng.integers(0, 1000, size=(B, d)).astype(np.int32)
    bi[np.isinf(bd)] = INVALID
    ci[np.isinf(cd)] = INVALID
    flags = [rng.random(s) < 0.5 for s in ((B, L), (B, L), (B, d), (B, d))]
    return bd, bi, flags[0], flags[1], cd, ci, flags[2], flags[3]


@pytest.mark.parametrize("B,L,d,n_inf_beam,p_inf", [
    (8, 30, 20, 5, 0.3),     # classic hop: L = 30, d = 20
    (4, 30, 80, 0, 0.5),     # fused E = 4 hop: E*d = 80 candidates
    (5, 12, 8, 12, 0.0),     # all-inf beam (fresh lanes)
    (3, 10, 16, 2, 1.0),     # all-inf candidates (a dead lane's hop)
])
def test_beam_merge_plain_matches_jax_exactly(B, L, d, n_inf_beam, p_inf):
    rng = np.random.default_rng(B * 100 + d)
    pool = np.array([0.5, 1.0, 1.0, 2.0, 3.5], np.float32)
    bd, bi, bc, bx, cd, ci, cc, cx = _beam_inputs(rng, B, L, d, n_inf_beam,
                                                  p_inf, pool)
    got = bm_ops.beam_merge(T(bd), T(bi), T(bc), T(bx), T(cd), T(ci), T(cx),
                            cand_chk=T(cc))
    want = j_beam_merge_ref(*[jnp.asarray(x) for x in
                              (bd, bi, bc, bx, cd, ci, cc, cx)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # default cand_chk (all False) against the jnp bitonic network
    got = bm_ops.beam_merge(T(bd), T(bi), T(bc), T(bx), T(cd), T(ci), T(cx))
    want = jbm_ops.beam_merge(*[jnp.asarray(x) for x in
                                (bd, bi, bc, bx, cd, ci, cx)], backend="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _hop_inputs(rng, E, with_visited, N=60, n_valid=50, d=8, m=16, B=6):
    adj = rng.integers(0, N + 5, size=(N, d)).astype(np.int32)   # some >= N
    adj[rng.random((N, d)) < 0.1] = INVALID
    vecs = rng.normal(size=(N + 5, m)).astype(np.float32)
    qs = rng.normal(size=(B, m)).astype(np.float32)
    sel = rng.integers(0, N, size=(B, E)).astype(np.int32)
    sel[0, 0] = INVALID                    # an inactive selection
    sel[1, -1] = N + 3                     # out of range: clipped to N-1
    if E > 1:
        sel[2, 1] = sel[2, 0]              # two selections share neighbors
    dmax = np.full((B,), np.inf, np.float32)
    dmax[::2] = np.median(np.linalg.norm(vecs[:, None] - qs[None], axis=-1))
    vis = None
    if with_visited:
        vis = jv.make_table(B, 64)
        seen = adj[sel.clip(0, N - 1)].reshape(B, -1)[:, ::3]
        vis = np.array(jv.insert(vis, jnp.asarray(seen),
                                 jnp.asarray(seen != INVALID)))
    return adj, vecs, sel, qs, dmax, vis, n_valid


@pytest.mark.parametrize("with_visited", [False, True])
@pytest.mark.parametrize("E", [1, 2, 4])
@pytest.mark.parametrize("squared", [False, True])
def test_fused_hop_plain_matches_jax(E, with_visited, squared):
    rng = np.random.default_rng(10 * E + with_visited)
    adj, vecs, sel, qs, dmax, vis, n_valid = _hop_inputs(rng, E, with_visited)
    got = fh_ops.fused_hop(T(adj), T(vecs), T(sel), T(qs), T(dmax),
                           None if vis is None else T(vis), n_valid=n_valid,
                           squared=squared)
    # the JAX oracle clamps an out-of-range selection through its gather;
    # the clip is spelled out here so both sides see the same rows
    jsel = np.where(sel == INVALID, INVALID, sel.clip(0, adj.shape[0] - 1))
    want = j_fused_hop_ref(jnp.asarray(adj), jnp.asarray(vecs),
                           jnp.asarray(jsel), jnp.asarray(qs),
                           jnp.asarray(dmax),
                           None if vis is None else jnp.asarray(vis),
                           n_valid=jnp.int32(n_valid), squared=squared)
    cid, cd, nbr, ev = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), cid)
    np.testing.assert_allclose(got[1].numpy(), cd, rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), nbr)
    np.testing.assert_array_equal(got[3].numpy(), ev)
    assert (got[2].numpy() < n_valid).all()
    assert ev.sum() > 0 and (cid != INVALID).any()
