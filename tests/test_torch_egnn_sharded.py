"""The port's halo-sharded EGNN loss (``models.egnn.make_sharded_loss`` on
``torch.distributed``) against the JAX package's ``make_sharded_loss`` and
against ``loss_fn``, on the CPU.

The graph is ``_torch_dist.egnn_data`` (40 nodes, 160 edges, some -1
labels) with its edges partitioned by dst over four shards, the weights
the JAX package's ``init_params`` for the reduced config.  The torch side
is four gloo ranks on the ``(2, 2)`` debug mesh
(``_torch_dist.egnn_halo_rank``); the JAX side runs its halo loss on four
host devices in a subprocess started first.  The loss is held at rtol
1e-5, the gradients at rtol 1e-4 atol 1e-6, against both JAX and the
port's own ``loss_fn`` on the whole graph, which also shows that no
gradient is the world size times what it should be.  At world size 1 the
halo loss and its gradients are ``torch.equal`` to ``loss_fn``'s.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
import repro_torch.configs as tconfigs
from repro.models import egnn as JE
from repro_torch.data.graphs import partition_edges_by_dst
from repro_torch.interop import egnn_params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import process_group, spawn_ranks
from repro_torch.models import egnn as TE
from repro_torch.train import tree as T
from _torch_threads import _one_torch_thread  # noqa: F401

LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _cfg():
    cfg = tconfigs.get_arch("egnn").reduced()
    assert {k: getattr(cfg, k) for k in td.EGNN_CFG} == td.EGNN_CFG
    return cfg


def _params():
    jcfg = JE.EGNNConfig(name="egnn-reduced", **td.EGNN_CFG)
    return td.flat(jax.tree.map(np.asarray,
                                JE.init_params(jax.random.PRNGKey(0), jcfg)))


def _batch():
    return {k: torch.tensor(v)
            for k, v in td.egnn_batch(partition_edges_by_dst).items()}


def _loss_fn(params: dict):
    """The port's loss_fn on the whole partitioned graph: (loss, flat
    grads)."""
    views = T.tree_map(lambda t: t.requires_grad_(),
                       egnn_params_from_numpy(td.unflat(params), "cpu"))
    loss, _ = TE.loss_fn(views, _batch(), _cfg())
    grads = torch.autograd.grad(loss, T.leaves(views))
    return loss, td.flat(T.unflatten(views, [g.numpy() for g in grads]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("egnn")
    params = _params()
    pin, out = str(tmp / "params.npz"), str(tmp / "jax.npz")
    np.savez(pin, **params)
    proc = td.start_jax("egnn", out, pin)
    try:
        ranks = spawn_ranks(td.egnn_halo_rank, 4, (params,), timeout_s=240)
        jax_out = td.wait_jax(proc, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ranks.sort(key=lambda r: r["index"])
    loss, grads = _loss_fn(params)
    return {"ranks": ranks, "jax": jax_out, "params": params,
            "loss": float(loss.detach()), "grads": grads}


def _grads(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def test_every_rank_gets_the_same_loss_and_gradients(run):
    r0 = run["ranks"][0]
    assert [r["index"] for r in run["ranks"]] == [0, 1, 2, 3]
    assert {r["backend"] for r in run["ranks"]} == {"gloo"}
    for r in run["ranks"][1:]:
        assert r["loss"] == r0["loss"]
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, r0["grads"][k], err_msg=k)


def test_loss_and_gradients_match_jax_halo_loss(run):
    r0, j = run["ranks"][0], run["jax"]
    np.testing.assert_allclose(r0["loss"], j["sharded_loss"], **LOSS)
    want = _grads(j, "sharded_grad/")
    assert sorted(want) == sorted(r0["grads"])
    for k, g in r0["grads"].items():
        np.testing.assert_allclose(g, want[k], err_msg=k, **GRAD)


def test_loss_and_gradients_match_loss_fn(run):
    """The halo loss is ``loss_fn`` on the whole graph, in both packages:
    a gradient scaled by the world size would be 4x off here."""
    r0, j = run["ranks"][0], run["jax"]
    np.testing.assert_allclose(r0["loss"], run["loss"], **LOSS)
    np.testing.assert_allclose(run["loss"], j["full_loss"], **LOSS)
    jfull = _grads(j, "full_grad/")
    for k, g in r0["grads"].items():
        want = run["grads"][k]
        np.testing.assert_allclose(g, want, err_msg=k, **GRAD)
        np.testing.assert_allclose(want, jfull[k], err_msg=k, **GRAD)
        big = np.abs(want) > 1e-4
        if big.any():
            ratio = np.median(g[big] / want[big])
            assert abs(ratio - 1.0) < 1e-3, (k, ratio)


def test_collective_gradients_are_not_scaled(run):
    """psum_forward passes its cotangent through (ones on every rank, not
    the world size); replicated sums one from each rank; all_gather_rows'
    backward gives each rank its block of the cotangent summed over the
    ranks (every rank weights row i by i)."""
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["psum_grad"], np.ones(3))
        np.testing.assert_array_equal(r["replicated_grad"], np.full(3, 4.0))
        np.testing.assert_array_equal(r["gather_rows"], np.ones((8, 2)))
        i = r["index"]
        want = 4.0 * np.arange(2 * i, 2 * i + 2, dtype=np.float32)[:, None]
        np.testing.assert_array_equal(r["gather_grad"],
                                      np.broadcast_to(want, (2, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world_size_one_is_loss_fn_exactly(dtype):
    """At world size 1 the partition keeps the edge order and the
    collectives are identities: the halo loss and every gradient are
    ``torch.equal`` to ``loss_fn``'s on the same batch."""
    cfg = dataclasses.replace(_cfg(), dtype=getattr(torch, dtype))
    d = td.egnn_data()
    edges, valid = partition_edges_by_dst(d["edges"], 40, 1)
    np.testing.assert_array_equal(edges, d["edges"])
    batch = {k: torch.tensor(v) for k, v in d.items()}
    batch["edge_valid"] = torch.tensor(valid)
    params = egnn_params_from_numpy(td.unflat(_params()), "cpu")

    def grads(fn):
        views = T.tree_map(lambda t: t.detach().clone().requires_grad_(),
                           params)
        loss, _ = fn(views, batch)
        return loss, torch.autograd.grad(loss, T.leaves(views))

    with process_group("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        loss, g = grads(TE.make_sharded_loss(cfg, mesh, ("data", "model")))
    want, wg = grads(lambda p, b: TE.loss_fn(p, b, cfg))
    assert torch.equal(loss, want)
    for a, b in zip(g, wg):
        assert torch.equal(a, b)
