"""The port's EGNN (``repro_torch.models.egnn``) against the JAX package's
on the CPU, on the same weights (JAX's ``init_params`` carried across by
``interop.egnn_params_from_numpy``) and the same numpy-seeded graphs:

* ``egnn_forward`` with and without ``edge_valid``, ``egnn_forward_batched``
  and ``node_embeddings``, float32 at rtol 1e-5 atol 1e-5 and bfloat16 at
  2e-2, on the reduced config and at a width of 64 (the JAX side jitted);
* ``loss_fn`` for the node and the graph (mean-pooled) cases and every
  parameter's gradient against ``jax.grad`` (rtol 1e-4 atol 1e-6);
* the E(n) property (the twin of ``tests/test_arch_smoke.py::
  test_egnn_equivariance``), a graph with an isolated node, -1 labels,
  and the parameter tree's shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import egnn as JE
from repro_torch.interop import egnn_params_from_numpy
from repro_torch.models import egnn as TE
from repro_torch.train import tree as T
from _torch_threads import _one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
WIDTHS = {"reduced": {}, "w64": {"d_hidden": 64}}
DTYPE_CASES = [(w, d) for w in WIDTHS for d in ("float32", "bfloat16")]


def _cfgs(width, dtype="float32"):
    kw = WIDTHS[width]
    j = dataclasses.replace(jconfigs.get_arch("egnn").reduced(),
                            dtype=getattr(jnp, dtype), **kw)
    t = dataclasses.replace(tconfigs.get_arch("egnn").reduced(),
                            dtype=getattr(torch, dtype), **kw)
    return j, t


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JE.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _graph(cfg, n=40, e=160, seed=0):
    """The JAX smoke test's graph: numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "feats": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
        "coords": rng.normal(size=(n, 3)).astype(np.float32),
        "edges": rng.integers(0, n, size=(2, e)).astype(np.int32),
        "labels": rng.integers(0, cfg.n_classes, size=n).astype(np.int32),
    }


def _batched(cfg, B=4, n=10, e=24, seed=6):
    rng = np.random.default_rng(seed)
    return {
        "feats": rng.normal(size=(B, n, cfg.d_feat)).astype(np.float32),
        "coords": rng.normal(size=(B, n, 3)).astype(np.float32),
        "edges": rng.integers(0, n, size=(B, 2, e)).astype(np.int32),
        "edge_valid": rng.random((B, e)) > 0.2,
        "labels": rng.integers(0, cfg.n_classes, size=B).astype(np.int32),
    }


def _t(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=what, **tol)


def _valid(e, seed=1):
    return np.random.default_rng(seed).random(e) > 0.3


@pytest.mark.parametrize("width,dtype", DTYPE_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(width, dtype, masked):
    jcfg, tcfg = _cfgs(width, dtype)
    params = _params(jcfg)
    b = _graph(tcfg)
    ev = _valid(b["edges"].shape[1]) if masked else None
    tol = F32 if dtype == "float32" else BF16
    jargs = (jax.tree.map(jnp.asarray, params),
             *(jnp.asarray(b[k]) for k in ("feats", "coords", "edges")),
             None if ev is None else jnp.asarray(ev))
    jl, jx = jax.jit(lambda p, f, c, e, v: JE.egnn_forward(
        p, f, c, e, jcfg, edge_valid=v))(*jargs)
    tp = egnn_params_from_numpy(params, "cpu")
    tb = _t(b)
    tl, tx = TE.egnn_forward(tp, tb["feats"], tb["coords"], tb["edges"],
                             tcfg, edge_valid=None if ev is None else
                             torch.tensor(ev))
    assert tl.dtype == torch.float32 and tx.dtype == tcfg.dtype
    assert tl.shape == (40, tcfg.n_classes) and tx.shape == (40, 3)
    _close(tl, jl, tol, "logits")
    _close(tx, jx, tol, "coords")
    je = jax.jit(lambda p, f, c, e, v: JE.node_embeddings(
        p, f, c, e, jcfg, edge_valid=v))(*jargs)
    te = TE.node_embeddings(tp, tb["feats"], tb["coords"], tb["edges"], tcfg,
                            edge_valid=None if ev is None else
                            torch.tensor(ev))
    assert te.dtype == torch.float32 and te.shape == (40, tcfg.d_hidden)
    _close(te, je, tol, "embeddings")


@pytest.mark.parametrize("width,dtype", DTYPE_CASES)
@pytest.mark.parametrize("valid", [False, True])
def test_batched_forward_matches_jax(width, dtype, valid):
    jcfg, tcfg = _cfgs(width, dtype)
    params = _params(jcfg)
    b = _batched(tcfg)
    ev = b["edge_valid"] if valid else None
    tol = F32 if dtype == "float32" else BF16
    jl, jx = jax.jit(lambda p, f, c, e, v: JE.egnn_forward_batched(
        p, f, c, e, jcfg, v))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(b["feats"]),
        jnp.asarray(b["coords"]), jnp.asarray(b["edges"]),
        None if ev is None else jnp.asarray(ev))
    tb = _t(b)
    tl, tx = TE.egnn_forward_batched(
        egnn_params_from_numpy(params, "cpu"), tb["feats"], tb["coords"],
        tb["edges"], tcfg, None if ev is None else tb["edge_valid"])
    assert tl.shape == (4, 10, tcfg.n_classes) and tx.shape == (4, 10, 3)
    _close(tl, jl, tol, "logits")
    _close(tx, jx, tol, "coords")


def test_batched_forward_is_each_graph_alone():
    """The offset layout joins no two graphs: each graph's output equals
    ``egnn_forward`` of it alone."""
    _, tcfg = _cfgs("reduced")
    tp = TE.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tb = _t(_batched(tcfg))
    logits, x = TE.egnn_forward_batched(tp, tb["feats"], tb["coords"],
                                        tb["edges"], tcfg, tb["edge_valid"])
    for i in range(4):
        lg, xi = TE.egnn_forward(tp, tb["feats"][i], tb["coords"][i],
                                 tb["edges"][i], tcfg,
                                 edge_valid=tb["edge_valid"][i])
        torch.testing.assert_close(logits[i], lg, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(x[i], xi, rtol=1e-6, atol=1e-6)


def _loss_and_grads(params, batch, tcfg):
    tp = egnn_params_from_numpy(params, "cpu")
    views = T.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, m = TE.loss_fn(views, _t(batch), tcfg)
    grads = torch.autograd.grad(loss, T.leaves(views))
    return loss, m, T.unflatten(views, list(grads))


def _jax_loss_and_grads(params, batch, jcfg):
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JE.loss_fn(p, b, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, params), _j(batch))
    return loss, m, jax.tree.map(np.asarray, g)


def _assert_grads(got, want):
    g, w = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, GRAD, f"grad {path}")


def _node_batch(cfg, masked_labels=False):
    b = _graph(cfg)
    b["edge_valid"] = _valid(b["edges"].shape[1])
    if masked_labels:
        b["labels"][::3] = -1
    return b


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("case", ["node", "node_masked", "graph"])
def test_loss_and_gradients_match_jax_grad(width, case):
    jcfg, tcfg = _cfgs(width)
    params = _params(jcfg)
    b = _batched(tcfg) if case == "graph" else \
        _node_batch(tcfg, case == "node_masked")
    loss, m, grads = _loss_and_grads(params, b, tcfg)
    jloss, jm, jgrads = _jax_loss_and_grads(params, b, jcfg)
    _close(loss, jloss, F32, "loss")
    _close(m["nll"], jm["nll"], F32, "nll")
    _assert_grads(grads, jgrads)


def test_bfloat16_loss_matches_jax():
    jcfg, tcfg = _cfgs("w64", "bfloat16")
    params = _params(jcfg)
    b = _node_batch(tcfg)
    loss, _, _ = _loss_and_grads(params, b, tcfg)
    jloss, _, _ = _jax_loss_and_grads(params, b, jcfg)
    _close(loss, jloss, BF16, "loss")


def test_minus_one_labels_take_no_loss():
    """A -1 label adds nothing: the loss over a graph whose every third
    label is -1 is the mean NLL over the other nodes, and a label past
    n_classes is clipped into range, as in JAX."""
    _, tcfg = _cfgs("reduced")
    tp = TE.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = _t(_node_batch(tcfg, masked_labels=True))
    logits, _ = TE.egnn_forward(tp, b["feats"], b["coords"], b["edges"],
                                tcfg, edge_valid=b["edge_valid"])
    keep = b["labels"] >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, b["labels"].clamp_min(0).long()[:, None])[:, 0]
    loss, _ = TE.loss_fn(tp, b, tcfg)
    torch.testing.assert_close(loss, nll[keep].mean())
    none = dict(b, labels=torch.full_like(b["labels"], -1))
    assert float(TE.loss_fn(tp, none, tcfg)[0]) == 0.0
    over = dict(b, labels=torch.where(keep, b["labels"] + 100,
                                      b["labels"]))
    top = dict(b, labels=torch.where(keep, torch.full_like(
        b["labels"], tcfg.n_classes - 1), b["labels"]))
    assert torch.equal(TE.loss_fn(tp, over, tcfg)[0],
                       TE.loss_fn(tp, top, tcfg)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_isolated_node_matches_jax(dtype):
    """Node 0 has no edge at all and node 1 only outgoing ones: their
    in-degree is 0, the mean divides by 1, and they keep their coords."""
    jcfg, tcfg = _cfgs("reduced", dtype)
    params = _params(jcfg)
    b = _graph(tcfg)
    e = b["edges"]
    e[:, (e[0] == 0) | (e[1] == 0)] = 2
    e[1, e[1] == 1] = 3
    b["labels"][5] = -1
    tol = F32 if dtype == "float32" else BF16
    jl, jx = JE.egnn_forward(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(b["feats"]),
                             jnp.asarray(b["coords"]), jnp.asarray(e), jcfg)
    tb = _t(b)
    tl, tx = TE.egnn_forward(egnn_params_from_numpy(params, "cpu"),
                             tb["feats"], tb["coords"], tb["edges"], tcfg)
    _close(tl, jl, tol, "logits")
    _close(tx, jx, tol, "coords")
    np.testing.assert_array_equal(_f32(tx[:2]), _f32(tb["coords"][:2].to(
        tcfg.dtype)))
    if dtype == "float32":
        loss, _, grads = _loss_and_grads(params, b, tcfg)
        jloss, _, jgrads = _jax_loss_and_grads(params, b, jcfg)
        _close(loss, jloss, F32, "loss")
        _assert_grads(grads, jgrads)


def test_equivariance():
    """E(n) property: rotate+translate inputs => coords transform likewise,
    invariant node logits (the twin of the JAX package's test)."""
    _, tcfg = _cfgs("reduced")
    params = egnn_params_from_numpy(_params(_cfgs("reduced")[0]), "cpu")
    b = _t(_graph(tcfg, seed=4))
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    R = torch.tensor(q.astype(np.float32))
    t = torch.tensor(rng.normal(size=(3,)).astype(np.float32))
    lg1, c1 = TE.egnn_forward(params, b["feats"], b["coords"], b["edges"],
                              tcfg)
    lg2, c2 = TE.egnn_forward(params, b["feats"], b["coords"] @ R.T + t,
                              b["edges"], tcfg)
    np.testing.assert_allclose(lg1.numpy(), lg2.numpy(), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose((c1 @ R.T + t).numpy(), c2.numpy(), rtol=1e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch_cfg", ["reduced", "published"])
def test_parameter_tree_matches_jax(arch_cfg):
    """``init_params`` and ``abstract_params`` give the JAX tree's paths,
    shapes and float32; the biases are zero; the weights' scale is
    1/sqrt(fan_in) times a normal truncated to [-2, 2]."""
    jspec, tspec = jconfigs.get_arch("egnn"), tconfigs.get_arch("egnn")
    jcfg, tcfg = ((jspec.reduced(), tspec.reduced()) if arch_cfg == "reduced"
                  else (jspec.model, tspec.model))
    want = jax.eval_shape(lambda: JE.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TE.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    abst = TE.abstract_params(tcfg)
    jabs = JE.abstract_params(jcfg)
    for tree in (got, abst):
        lw = T.leaves_with_path(tree)
        assert [p for p, _ in lw] == [p for p, _ in
                                      T.leaves_with_path(want)]
        for (path, a), (_, w) in zip(lw, T.leaves_with_path(want)):
            assert tuple(a.shape) == tuple(w.shape), path
            assert a.dtype == torch.float32
    assert [tuple(s.shape) for _, s in T.leaves_with_path(jabs)] == \
        [tuple(a.shape) for _, a in T.leaves_with_path(abst)]
    assert all(a.device.type == "meta" for a in T.leaves(abst))
    for path, a in T.leaves_with_path(got):
        if path[-1].startswith("b"):
            assert not a.any(), path
        else:
            fan_in = a.shape[-2]
            assert float(a.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6
    assert got["layers"]["phi_e"]["w0"].shape[0] == tcfg.n_layers
    # the layers are drawn one after another, not copies of one draw
    w = got["layers"]["phi_h"]["w0"]
    assert not torch.equal(w[0], w[1])


def test_config_crosses_over():
    j, t = jconfigs.get_arch("egnn"), tconfigs.get_arch("egnn")
    for a, b in ((j.model, t.model), (j.reduced(), t.reduced())) + tuple(
            (j.model_for(s), t.model_for(s)) for s in
            ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("dtype") == jnp.float32 and db.pop("dtype") == \
            torch.float32
        assert da == db
    assert t.notes == j.notes and t.family == j.family == "gnn"
    assert [(c.name, c.kind, c.dims) for c in t.shapes] == \
        [(c.name, c.kind, c.dims) for c in j.shapes]
