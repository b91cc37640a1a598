"""The port's recsys serving path against the JAX package, on the CPU.

Both packages compute with the same weights (the JAX ``init_params``
carried across by ``interop.recsys_model_from_numpy``) on the same
batches (``CriteoLikeStream``, byte-equal in both packages).  Cases: the
four ``reduced()`` configs, DIN at its published width (B=16; the table
is 256,205 x 18, 18 MB), and a reduced DIN whose item field is 1, which
catches a history id of -1 turned into another field's row (trap (a) in
``models/recsys.py::history_ids``).  Every DIN batch holds one row whose
history is all -1.

Tolerances: logits, losses and user embeddings at rtol 1e-5 / atol 1e-6
(float32 in both packages; the matrix products and the bag sums add in
different orders); retrieval scores at the same tolerance, ids equal
except where two candidates tie within it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import base as jbase
from repro.data.recsys import CriteoLikeStream as JStream
from repro.models import recsys as JR
import repro_torch.configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.data.recsys import CriteoLikeStream as TStream
from repro_torch.interop import recsys_model_from_numpy
from repro_torch.kernels.bag_lookup import ops as bag_ops
from repro_torch.models import recsys as TR
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["dcn-v2", "deepfm", "din", "dlrm-mlperf"]
CASES = ARCHS + ["din-full", "din-item1"]


def _configs(case):
    """(JAX config, port config) of a test case."""
    if case == "din-full":
        return jconfigs.get_arch("din").model, tconfigs.get_arch("din").model
    if case == "din-item1":
        return (dataclasses.replace(jconfigs.get_arch("din").reduced(),
                                    item_field=1),
                dataclasses.replace(tconfigs.get_arch("din").reduced(),
                                    item_field=1))
    return (jconfigs.get_arch(case).reduced(),
            tconfigs.get_arch(case).reduced())


def _batch(cfg, B, step=0):
    b = JStream(cfg, seed=3).batch(step, B)
    if cfg.kind == "din":
        b["hist"][1, :] = -1                             # an empty history
    return b


@pytest.fixture(scope="module", params=CASES)
def case(request):
    jcfg, tcfg = _configs(request.param)
    params = jax.tree.map(np.asarray,
                          JR.init_params(jax.random.PRNGKey(1), jcfg))
    model = recsys_model_from_numpy(params, tcfg, device="cpu")
    B = 16 if request.param == "din-full" else 12
    batch = _batch(jcfg, B)
    return dict(name=request.param, jcfg=jcfg, params=params, model=model,
                batch=batch, tbatch=TR.as_tensors(batch, "cpu"))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_forward_matches_jax(case):
    got = TR.forward(case["model"], case["tbatch"])
    want = JR.forward(case["params"], _jbatch(case["batch"]), case["jcfg"])
    assert got.dtype == torch.float32 and got.shape == (len(case["batch"]["label"]),)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_module_forward_is_the_function(case):
    torch.testing.assert_close(case["model"](case["tbatch"]),
                               TR.forward(case["model"], case["tbatch"]),
                               rtol=0, atol=0)


def test_loss_matches_jax(case):
    loss, aux = TR.loss_fn(case["model"], case["tbatch"])
    jloss, jaux = JR.loss_fn(case["params"], _jbatch(case["batch"]),
                             case["jcfg"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux["bce"]), float(jaux["bce"]),
                               rtol=RTOL, atol=ATOL)


def test_user_embedding_matches_jax(case):
    got = TR.user_embedding(case["model"], case["tbatch"]).numpy()
    want = np.asarray(JR.user_embedding(case["params"], _jbatch(case["batch"]),
                                        case["jcfg"]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case["jcfg"].kind == "din":                       # the empty history
        np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))


def test_serve_retrieval_matches_jax(case):
    jcfg, model = case["jcfg"], case["model"]
    field = jcfg.item_field if jcfg.kind == "din" else 0
    cands = TR.item_vectors(model, field)
    jcands = JR.item_vectors(jax.tree.map(jnp.asarray, case["params"]), jcfg,
                             field)
    np.testing.assert_array_equal(cands.numpy(), np.asarray(jcands))
    k = min(10, cands.shape[0])
    top, ids = TR.serve_retrieval(model, case["tbatch"], cands, k)
    jtop, jids = JR.serve_retrieval(case["params"], _jbatch(case["batch"]),
                                    jcands, jcfg, k)
    jtop, jids = np.asarray(jtop), np.asarray(jids)
    assert ids.dtype == torch.int32
    np.testing.assert_allclose(top.numpy(), jtop, rtol=RTOL, atol=ATOL)
    # a differing id must be a tie: its own score equals the slot's score
    u = TR.user_embedding(model, case["tbatch"])
    own = (u[:, None, :] * cands[ids.long()]).sum(-1).numpy()
    np.testing.assert_allclose(own, jtop, rtol=RTOL, atol=ATOL)
    # and a slot whose score is apart from its neighbours' holds one id
    s = -np.sort(-(u.numpy() @ cands.numpy().T), axis=1)[:, : k + 1]
    gap = np.abs(np.diff(s, axis=1)) > ATOL + RTOL * np.abs(s[:, 1:])
    apart = gap[:, :k] & np.concatenate(
        [np.ones((s.shape[0], 1), bool), gap[:, : k - 1]], axis=1)
    np.testing.assert_array_equal(ids.numpy()[apart], jids[apart])


def test_din_history_keeps_padding_invalid():
    """Trap (a): with the item field not first, ``hist + offset`` would
    turn -1 into the last row of the field before; ``history_ids`` keeps
    it -1, and a reduced DIN whose item field is 1 still matches JAX on a
    batch with an empty history (``test_forward_matches_jax[din-item1]``)."""
    cfg = dataclasses.replace(tconfigs.get_arch("din").reduced(),
                              item_field=1)
    hist = torch.tensor([[3, 0, -1, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    got = TR.history_ids(cfg, hist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [[53, 50, -1, -1],
                                                [-1, -1, -1, -1]])


def test_default_lookup_raises_on_ids_outside_the_table():
    """Trap (b): ``jnp.take`` returns NaN rows for ids >= V; the port does
    what torch indexing does, which on the CPU is an IndexError."""
    table = torch.zeros((5, 3))
    with pytest.raises(IndexError):
        TR.default_lookup(table, torch.tensor([[1, 5]], dtype=torch.int32))


@pytest.mark.parametrize("entry", ["user_embedding", "serve_retrieval"])
@pytest.mark.parametrize("arch", ["dcn-v2", "din"])
def test_user_embedding_raises_on_ids_outside_the_table(arch, entry):
    """``user_embedding`` (and so ``serve_retrieval``) raises IndexError on
    a row id past the stacked table, as ``forward`` does through
    ``default_lookup``: the bag would clip it to the last row, and the JAX
    package's ``jnp.take`` gives NaN there.  The same batch without that
    id, DIN's -1 history padding in it, pools as the JAX package does."""
    jcfg, tcfg = _configs(arch)
    params = jax.tree.map(np.asarray,
                          JR.init_params(jax.random.PRNGKey(1), jcfg))
    model = recsys_model_from_numpy(params, tcfg, device="cpu")
    batch = _batch(jcfg, 4)
    cands = TR.item_vectors(model, jcfg.item_field if arch == "din" else 0)

    def run(b):
        tb = TR.as_tensors(b, "cpu")
        if entry == "user_embedding":
            return TR.user_embedding(model, tb)
        return TR.serve_retrieval(model, tb, cands, 5)[0]

    got = run(batch)
    assert bool(torch.isfinite(got).all())
    if entry == "user_embedding":
        want = JR.user_embedding(params, _jbatch(batch), jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    bad = {key: v.copy() for key, v in batch.items()}
    n_rows = model.table.shape[0]
    offsets = np.cumsum([0, *jcfg.vocab_sizes[:-1]])
    if arch == "din":               # a history id one past the table's end
        bad["hist"][0, 0] = n_rows - offsets[jcfg.item_field]
    else:                           # the last field's id one past its vocab
        bad["sparse"][0, -1] = jcfg.vocab_sizes[-1]
    with pytest.raises(IndexError):
        run(bad)
    want = JR.user_embedding(params, _jbatch(bad), jcfg)
    assert not np.isfinite(np.asarray(want)[0]).all()


@pytest.mark.parametrize("n", [2, 5, 27])
def test_dlrm_interaction_pair_order_matches_jax(n):
    """Trap (c): the pairs come in ``jnp.triu_indices(n, k=1)`` order."""
    rng = np.random.default_rng(n)
    emb = rng.normal(size=(3, n - 1, 4)).astype(np.float32)
    bot = rng.normal(size=(3, 4)).astype(np.float32)
    got = TR._dlrm_interact(torch.from_numpy(emb), torch.from_numpy(bot))
    want = JR._dlrm_interact(jnp.asarray(emb), jnp.asarray(bot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_jax(arch):
    """``init_params`` draws every leaf the JAX package draws, in its shape,
    from a torch.Generator: tables at 0.01 times a normal truncated to
    [-2, 2], zero biases."""
    jcfg, tcfg = _configs(arch)
    want = jax.tree.map(np.shape, JR.init_params(jax.random.PRNGKey(0), jcfg))
    model = TR.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {}
    for name, p in model.named_parameters():
        top, _, leaf = name.partition(".")
        if leaf:
            got.setdefault(top, {})[leaf] = tuple(p.shape)
        else:
            got[top] = tuple(p.shape)
    assert got == want
    assert not any(p.requires_grad for p in model.parameters())
    table = model.table
    assert float(table.abs().max()) <= 0.02 and float(table.std()) > 0.004
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("b") or name == "cross_b":
            assert not p.any(), name
    again = TR.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(again.table, table, rtol=0, atol=0)


def test_dense_init_scale_and_bounds():
    from repro_torch.models.layers import dense_init

    w = dense_init(torch.Generator().manual_seed(0), (400, 300), device="cpu")
    bound = 2.0 / np.sqrt(400)
    assert float(w.abs().max()) <= bound * (1 + 1e-6)
    # a standard normal truncated to [-2, 2] has a std of 0.8796
    np.testing.assert_allclose(float(w.std()) * np.sqrt(400), 0.8796,
                               rtol=0.02)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_batches_byte_equal(arch):
    for cfg_of in (lambda s: s.reduced(), lambda s: s.model):
        jcfg = cfg_of(jconfigs.get_arch(arch))
        tcfg = cfg_of(tconfigs.get_arch(arch))
        for step in (0, 5):
            a = JStream(jcfg, seed=7).batch(step, 64)
            b = TStream(tcfg, seed=7).batch(step, 64)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = np.dtype(jnp.dtype(cfg.dtype).name if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch."))
    return d


def _cells(shapes):
    """ShapeCells as plain tuples (the two packages' classes differ)."""
    return tuple(dataclasses.astuple(c) for c in shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_specs_equal_jax(arch):
    j, t = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for f in ("name", "family", "skip", "notes", "shape_overrides"):
        assert getattr(j, f) == getattr(t, f), f
    assert _cells(j.shapes) == _cells(t.shapes)
    assert _as_dict(j.model) == _as_dict(t.model)
    assert _as_dict(j.reduced()) == _as_dict(t.reduced())
    assert j.model.total_rows == t.model.total_rows
    assert j.model.x0_dim == t.model.x0_dim
    for cell in t.shapes:
        assert _cells([t.cell(cell.name)]) == _cells([j.cell(cell.name)])
        assert t.model_for(cell.name) is t.model


def test_recsys_shapes_equal_jax():
    assert _cells(tbase.RECSYS_SHAPES) == _cells(jbase.RECSYS_SHAPES)
    assert tbase.RECSYS_SHAPES[1]["batch"] == 512
    # the ported registry: the recsys archs, the five LM archs and, since
    # the EGNN slice, EGNN: the JAX registry's every arch
    assert set(ARCHS) <= set(tconfigs.list_archs())
    assert tconfigs.list_archs() == jconfigs.list_archs()


@pytest.mark.parametrize("name", ["phi3-mini", "egnn-reduced",
                                  "no-such-arch"])
def test_get_arch_rejects_names_the_port_does_not_serve(name):
    """Names neither registry knows (a cut LM name and the reduced EGNN
    config's name among them) raise the JAX registry's ValueError in the
    port."""
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_arch(name)


def test_serving_on_the_cpu_launches_nothing(case):
    before = bag_ops.launches
    TR.forward(case["model"], case["tbatch"])
    TR.user_embedding(case["model"], case["tbatch"])
    assert bag_ops.launches == before
