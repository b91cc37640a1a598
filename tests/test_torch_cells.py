"""The port's cell builder (``repro_torch.launch.cells``) against
``repro.launch.cells`` and against the port's unsharded functions.

* Structure: for every cell of the registry, the three ``deg-ann`` cells
  and each variant where it applies (``tests/_torch_cells.py::cells``),
  the port's cell on the abstract ``(2, 2)`` mesh against JAX's
  ``build_cell`` on the ``(2, 2)`` debug mesh of 8 host devices (run once,
  in a subprocess): the arguments' shapes and dtypes leaf for leaf, the
  in and out specs, ``donate``, ``kind`` and ``meta`` (``cfg`` aside), or
  the same ``SkippedCell`` reason; and ``VARIANTS``.
* Runs: each family's ``fn`` at world size 1 on one gloo rank with real
  tensors whose shapes equal its meta arguments: the LM cells at their
  ``reduced()`` width and a cut batch and length, EGNN full_graph_sm
  (plain and halo) and molecule and DIN serve_p99 at full size, the other
  recsys cells at ``reduced()`` width, each ``torch.equal`` to the port's
  unsharded function; the deg-ann cells' step over a small index against
  ``range_search``; the recsys train cell's table gradient against the
  unsharded one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_cells as tc
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import cells as C
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.launch.ranks import process_group
from repro_torch.train import tree as T
from _torch_threads import _one_torch_thread  # noqa: F401

KINDS = {(a, s): get_arch(a).cell(s).kind for a, s in all_cells()}
CELLS = tc.cells(all_cells(), KINDS)
IDS = [tc.cell_id(*c) for c in CELLS]


def _specs(tree) -> dict:
    return {"/".join(str(k) for k in path): tc.spec_json(s)
            for path, s in T.leaves_with_path(tree)}


def _abstract(tree) -> dict:
    return {"/".join(str(k) for k in path):
            [list(t.shape), str(t.dtype).removeprefix("torch.")]
            for path, t in T.leaves_with_path(tree)}


def _meta(meta: dict) -> dict:
    def plain(v):
        return list(v) if isinstance(v, tuple) else v

    return {k: plain(v) for k, v in meta.items() if k != "cfg"}


def port_cell(arch, shape, variant) -> dict:
    mesh = abstract_mesh(*tc.MESHES["2x2"])
    try:
        prog = C.build_cell(arch, shape, mesh, variant)
    except C.SkippedCell as exc:
        return {"skip": str(exc)}
    return {"kind": prog.kind, "donate": list(prog.donate),
            "args": [_abstract(a) for a in prog.args],
            "in_specs": [_specs(s) for s in prog.in_specs],
            "out_specs": _specs(prog.out_specs), "meta": _meta(prog.meta)}


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cells") / "jax.json")
    return tc.wait(tc.start("cells", out), out)


def test_cell_list_covers_the_registry(jax_cells):
    assert sorted(jax_cells["cells"]) == sorted(IDS)
    assert len(all_cells()) == 40 and len(IDS) == len(set(IDS))


def test_variants_equal_jax(jax_cells):
    assert sorted(C.VARIANTS) == jax_cells["variants"]


@pytest.mark.parametrize("arch, shape, variant", CELLS, ids=IDS)
def test_cell_equals_jax(jax_cells, arch, shape, variant):
    want = jax_cells["cells"][tc.cell_id(arch, shape, variant)]
    got = port_cell(arch, shape, variant)
    if "skip" in want:
        assert got == want and get_arch(arch).skip[shape] == want["skip"]
        return
    for key in ("kind", "donate", "meta", "out_specs"):
        assert got[key] == want[key], key
    assert len(got["args"]) == len(want["args"])
    for i, (g, w) in enumerate(zip(got["args"], want["args"])):
        assert g == w, f"argument {i}"
    for i, (g, w) in enumerate(zip(got["in_specs"], want["in_specs"])):
        assert g == w, f"in_specs {i}"


def test_skipped_cells_raise():
    mesh = abstract_mesh(*tc.MESHES["2x2"])
    with pytest.raises(C.SkippedCell):
        C.build_cell("phi3-mini-3.8b", "long_500k", mesh)


def test_cells_build_on_the_production_meshes():
    """The (16, 16) and (2, 16, 16) shapes, no rank behind them: every
    cell builds with its placements; a step runs only over a DeviceMesh."""
    for name in ("16x16", "2x16x16"):
        mesh = abstract_mesh(*tc.MESHES[name])
        for arch, shape, variant in CELLS:
            try:
                prog = C.build_cell(arch, shape, mesh, variant)
            except C.SkippedCell:
                continue
            prog.placements(mesh)
    prog = C.build_cell("deg-ann", "search_16m", mesh)
    assert prog.meta["n_shards"] == 16 and prog.meta["n_per_shard"] == 1 << 20
    with pytest.raises(TypeError, match="abstract mesh"):
        prog.fn(*[torch.zeros(1) for _ in prog.args])


def test_padding_policy():
    """Edges padded to the device count, nodes to the DP axes (every axis
    under nodeshard), tables to the model axis, candidates to DP."""
    mesh = abstract_mesh(*tc.MESHES["2x16x16"])
    e = C.build_cell("egnn", "full_graph_sm", mesh).meta
    assert (e["n_nodes_pad"], e["n_edges_pad"]) == (2720, 10752)
    e = C.build_cell("egnn", "full_graph_sm", mesh, "nodeshard").meta
    assert e["n_nodes_pad"] == 3072
    r = C.build_cell("deepfm", "retrieval_cand", mesh).meta
    assert r["n_candidates_pad"] == 1_000_000 and r["cfg"].table_pad_to == 16
    assert r["cfg"].total_rows % 16 == 0


# ---------------------------------------------------------------------------
# runs at world size 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    with process_group("gloo"):
        yield make_mesh((1, 1), ("data", "model"), "cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _equal(got, want):
    ga, wa = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in ga] == [p for p, _ in wa]
    for (p, a), (_, b) in zip(ga, wa):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def _args_match(args, prog):
    got = [(p, tuple(t.shape), t.dtype) for a in args
           for p, t in T.leaves_with_path(a)]
    want = [(p, tuple(t.shape), t.dtype) for a in prog.args
            for p, t in T.leaves_with_path(a)]
    assert got == want


LM_SMALL = dict(seq_len=16, global_batch=4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
def test_lm_cells_run(mesh, arch):
    """The reduced LM's train (seqpar + microbatches too), prefill and
    decode cells at B=4, S=16, torch.equal to the unsharded step,
    serve_prefill and serve_decode_step."""
    from repro_torch.models import transformer as TT
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    spec = get_arch(arch)
    model = spec.reduced()
    rng = np.random.default_rng(0)
    for variant in ("", "seqpar+microbatch4"):
        opts = C.VARIANTS[variant]
        prog = C._lm_train(spec, ShapeCell("train_4k", "train", LM_SMALL),
                           mesh, model, **opts)
        cfg = prog.meta["cfg"]
        params = TT.init_params(cfg, _gen(), "cpu").params()
        toks = torch.tensor(rng.integers(0, cfg.vocab, (4, 16)),
                            dtype=torch.int32)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        opt = adamw(1e-4, weight_decay=0.1)
        args = (T.tree_map(torch.clone, params), opt.init(params), batch)
        _args_match(args, prog)
        want = make_train_step(lambda p, b: TT.loss_fn(p, b, cfg), opt,
                               microbatches=opts.get("microbatches", 1))(
            T.tree_map(torch.clone, params), opt.init(params), batch)
        _equal(prog.fn(*args), want)
    prog = C._lm_prefill(spec, ShapeCell("prefill_32k", "prefill", LM_SMALL),
                         mesh, model)
    cfg = prog.meta["cfg"]
    params = TT.init_params(cfg, _gen(1), "cpu").params()
    toks = torch.tensor(rng.integers(0, cfg.vocab, (4, 16)),
                        dtype=torch.int32)
    _args_match((params, toks), prog)
    got = prog.fn(params, toks)
    want = TT.serve_prefill(params, toks, max_len=16, cfg=cfg)
    assert got[1]["pos"] == want[1]["pos"] == 16
    _equal((got[0], got[1]["k"], got[1]["v"]),
           (want[0], want[1]["k"], want[1]["v"]))
    prog = C._lm_decode(spec, ShapeCell("decode_32k", "decode", LM_SMALL),
                        mesh, model)
    cfg = prog.meta["cfg"]
    cache = TT.init_cache(cfg, 4, 16, "cpu")
    cache["pos"] = torch.tensor(0, dtype=torch.int32)
    token = toks[:, :1]
    _args_match((params, cache, token), prog)
    other = T.tree_map(torch.clone, cache)
    got = prog.fn(params, cache, token)
    want = TT.serve_decode_step(params, other, token, cfg=cfg)
    _equal((got[0], got[1]["k"], got[1]["v"]),
           (want[0], want[1]["k"], want[1]["v"]))


@pytest.mark.parametrize("shape, variant", [
    ("full_graph_sm", ""), ("full_graph_sm", "halo"), ("molecule", "")])
def test_egnn_cells_run(mesh, shape, variant):
    """full_graph_sm (plain and halo) and molecule at full size: one step
    of the cell torch.equal to make_train_step over loss_fn."""
    from repro_torch.models import egnn as E
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    prog = C.build_cell("egnn", shape, mesh, variant)
    cfg = prog.meta["cfg"]
    rng = np.random.default_rng(3)
    args_abs = prog.args[2]

    def draw(name, t):
        if name == "edge_valid":
            return torch.ones(t.shape, dtype=torch.bool)
        if t.dtype == torch.int32:
            hi = (cfg.n_classes if name == "labels"
                  else args_abs["feats"].shape[-2])
            return torch.tensor(rng.integers(0, hi, t.shape), dtype=torch.int32)
        return torch.tensor(rng.normal(size=t.shape), dtype=torch.float32)

    batch = {k: draw(k, t) for k, t in args_abs.items()}
    params = E.init_params(cfg, _gen(), "cpu")
    opt = adamw(1e-3)
    args = (T.tree_map(torch.clone, params), opt.init(params), batch)
    _args_match(args, prog)
    want = make_train_step(lambda p, b: E.loss_fn(p, b, cfg), opt)(
        T.tree_map(torch.clone, params), opt.init(params), batch)
    _equal(prog.fn(*args), want)


def _recsys(arch, shape, mesh, full=False):
    from repro_torch.data.recsys import CriteoLikeStream
    from repro_torch.models import recsys as R

    spec = get_arch(arch)
    prog = C.build_cell(arch, shape, mesh,
                        model=None if full else spec.reduced())
    cfg = prog.meta["cfg"]
    rec = R.init_params(cfg, _gen(), "cpu")
    batch = R.as_tensors(CriteoLikeStream(cfg, seed=0).batch(
        0, prog.meta["batch"]), "cpu")
    return prog, cfg, rec, batch


@pytest.mark.parametrize("arch, full", [
    ("din", True), ("dcn-v2", False), ("deepfm", False),
    ("dlrm-mlperf", False)])
def test_recsys_serve_cells_run(mesh, arch, full):
    from repro_torch.models import recsys as R

    prog, cfg, rec, batch = _recsys(arch, "serve_p99", mesh, full)
    del batch["label"]
    _args_match((rec.params(), batch), prog)
    _equal(prog.fn(rec.params(), batch), R.forward(rec, batch))


def test_recsys_retrieval_cell_runs(mesh):
    from repro_torch.models import recsys as R

    prog, cfg, rec, batch = _recsys("din", "retrieval_cand", mesh)
    del batch["label"]
    cands = torch.tensor(np.random.default_rng(5).normal(
        size=(4096, cfg.embed_dim)), dtype=torch.float32)
    scores, ids = prog.fn(rec.params(), batch, cands)
    want_s, want_i = R.serve_retrieval(rec, batch, cands, k=100)
    assert torch.equal(scores, want_s) and torch.equal(ids, want_i)


@pytest.mark.parametrize("arch", ["din", "deepfm"])
def test_recsys_train_cell_gradient_and_step(mesh, arch):
    """The train cell's loss through the row-sharded lookup: the table's
    gradient torch.equal to the unsharded loss_fn's, and one step of the
    cell equal to make_train_step over loss_fn under the MLPerf split."""
    from repro_torch.launch.train import mlperf_label
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw, partitioned, sgd
    from repro_torch.train.steps import _grads, make_train_step

    prog, cfg, rec, batch = _recsys(arch, "train_batch", mesh)
    batch = {k: v[:256] for k, v in batch.items()}
    params = rec.params()
    lookup = C.make_sharded_lookup(mesh, table_axis="model",
                                   batch_axes="data")
    _, _, g1 = _grads(lambda p, b: R.loss_fn(p, b, cfg, lookup_fn=lookup),
                      params, batch)
    _, _, g0 = _grads(lambda p, b: R.loss_fn(p, b, cfg), params, batch)
    assert bool(g0["table"].abs().sum() > 0)
    _equal(g1, g0)
    opt = partitioned(mlperf_label, {"embed": sgd(0.05),
                                     "dense": adamw(1e-3)})
    got = prog.fn(T.tree_map(torch.clone, params), opt.init(params), batch)
    want = make_train_step(lambda p, b: R.loss_fn(p, b, cfg), opt)(
        T.tree_map(torch.clone, params), opt.init(params), batch)
    _equal(got, want)


@pytest.fixture(scope="module")
def golden_graph():
    """The golden fixture's DEG (300 vertices, degree 8, dim 24)."""
    import os

    from repro_torch.interop import graph_from_numpy

    g = dict(np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "range_search_golden.npz")))
    return graph_from_numpy(g["adjacency"], g["weights"], g["n"],
                            "cpu"), g["vectors"]


@pytest.mark.parametrize("shape, variant", [
    ("search_16m", ""), ("explore_16m", ""), ("build_wave_16m", ""),
    ("search_16m", "bf16vecs")])
def test_deg_cell_step_equals_range_search(mesh, golden_graph, shape,
                                           variant):
    """The deg-ann cell's step, the same code path as at 2^24 rows, over
    the golden fixture's 300-vertex DEG at world size 1: ids and dists
    torch.equal to ``range_search`` from the seed vertex (the lane's first
    excluded id first where the cell excludes), k, L and eps as the cell
    has them."""
    from repro_torch.core.search import range_search

    prog = C.build_cell("deg-ann", shape, mesh, variant)
    c, vdt = prog.meta, prog.args[1].dtype
    g, vecs = golden_graph
    rng = np.random.default_rng(4)
    n, dim = vecs.shape
    rows = torch.tensor(vecs).to(vdt)
    q = torch.tensor(vecs[:32] + 0.05 * rng.normal(size=(32, dim)),
                     dtype=torch.float32).to(vdt)
    seed = 7
    args = [g.adjacency[None], rows[None],
            torch.tensor([g.n], dtype=torch.int32),
            torch.tensor([seed], dtype=torch.int32), q]
    seeds = torch.full((32, 1), seed, dtype=torch.int32)
    excl = None
    if c.get("exclude"):
        excl = torch.tensor(rng.integers(0, n, (32, c["exclude"])),
                            dtype=torch.int32)
        excl[::5, 3] = -1
        args.append(excl)
        seeds = torch.cat([excl[:, :1], seeds], 1)
    ids, dists = prog.fn(*args)
    L = max(c["beam"], c["k"], seeds.shape[1],
            c["k"] + (0 if excl is None else excl.shape[1]))
    want = range_search(g, rows, q.to(torch.float32), seeds, k=c["k"],
                        eps=0.1, beam_width=L, exclude=excl)
    assert torch.equal(ids, want.ids) and torch.equal(dists, want.dists)
    if excl is not None:
        assert not (ids[:, :, None] == excl[:, None, :]).any()


@pytest.mark.parametrize("arch", ["din", "deepfm"])
def test_sharded_lookup_gradient_on_four_ranks(arch):
    """The train cell's loss through the row-sharded lookup on the (2, 2)
    gloo mesh (the table in two row blocks, the batch in two): every rank
    gets the same loss and gradients, the unsharded loss_fn's within
    float32 summation order (rtol 1e-5 atol 1e-7)."""
    from repro_torch.data.recsys import CriteoLikeStream
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models import recsys as R
    from repro_torch.train.steps import _grads

    cfg = dataclasses.replace(get_arch(arch).reduced(), table_pad_to=2)
    params = R.init_params(cfg, _gen(), "cpu").params()
    batch = R.as_tensors(CriteoLikeStream(cfg, seed=0).batch(0, 64), "cpu")
    ranks = spawn_ranks(tc.lookup_grad_rank, 4, (
        arch, T.tree_map(lambda t: t.numpy(), params),
        {k: v.numpy() for k, v in batch.items()}, (2, 2)), timeout_s=180)
    loss, _, grads = _grads(lambda p, b: R.loss_fn(p, b, cfg), params, batch)
    want = {T.key_of(k): v.numpy() for k, v in T.leaves_with_path(grads)}
    assert sorted(r["index"] for r in ranks) == [0, 1, 2, 3]
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        assert sorted(r["grads"]) == sorted(want)
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, ranks[0]["grads"][k])
            np.testing.assert_allclose(g, want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert np.abs(want["table"]).sum() > 0


def test_recsys_cell_config_pads_the_table():
    mesh = abstract_mesh((1, 3), ("data", "model"))
    prog = C.build_cell("din", "serve_p99", mesh)
    assert prog.meta["cfg"].table_pad_to == 3
    assert prog.args[0]["table"].shape[0] % 3 == 0
    assert dataclasses.replace(prog.meta["cfg"], table_pad_to=1).total_rows \
        == get_arch("din").model.total_rows
