"""The port's placement rules (``repro_torch.distributed.sharding``) held
leaf for leaf against ``repro.distributed.sharding``: every rule, for
every arch of the registry, on the abstract ``(2, 2)``, ``(16, 16)`` and
``(2, 16, 16)`` meshes.  The JAX side runs once, in a subprocess
(``tests/_torch_cells.py sharding``, 512 forced host devices for
``egnn_batch_specs``), while the port computes its own; then the tests
only compare.  Also ``placements``, the abstract mesh, and the
optimizer-state specs of the partitioned MLPerf state."""
import pytest
import torch

import _torch_cells as tc
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Spec
from repro_torch.launch.mesh import abstract_mesh, axis_group
from repro_torch.launch.train import mlperf_label
from repro_torch.models import egnn as E
from repro_torch.models import recsys as R
from repro_torch.models import transformer as TT
from repro_torch.train import tree as T
from repro_torch.train.optimizer import adamw, partitioned, sgd
from _torch_threads import _one_torch_thread  # noqa: F401


def _specs(tree) -> dict:
    return {"/".join(str(k) for k in path): tc.spec_json(s)
            for path, s in T.leaves_with_path(tree)}


def _mlperf_opt():
    return partitioned(mlperf_label, {"embed": sgd(0.05),
                                      "dense": adamw(1e-3)})


def port_rules(mesh) -> dict:
    """The port's side of ``tests/_torch_cells.py``'s ``sharding`` case on
    one mesh, under the same keys."""
    res = {"dp_axes": tc.spec_json([SH.dp_axes(mesh)])}
    for arch in list_archs():
        spec = get_arch(arch)
        if spec.family == "lm":
            cfg = spec.model
            p = SH.lm_param_specs(cfg, mesh)
            res[f"{arch}/params"] = _specs(p)
            res[f"{arch}/batch"] = _specs(SH.lm_batch_specs(mesh))
            st = adamw(1e-4).init(TT.abstract_params(cfg))
            res[f"{arch}/opt"] = _specs(SH.opt_state_specs(p, st))
            for c in spec.shapes:
                res[f"{arch}/{c.name}/cache"] = _specs(
                    SH.lm_cache_specs(cfg, mesh, c["global_batch"]))
        elif spec.family == "gnn":
            for c in spec.shapes:
                cfg = spec.model_for(c.name)
                res[f"{arch}/{c.name}/params"] = _specs(
                    SH.egnn_param_specs(E.abstract_params(cfg)))
                res[f"{arch}/{c.name}/batch"] = _specs(
                    SH.egnn_batch_specs(mesh, c.kind, c.dims))
        else:
            cfg = spec.model
            p = SH.recsys_param_specs(cfg, mesh)
            res[f"{arch}/params"] = _specs(p)
            st = _mlperf_opt().init(R.abstract_params(cfg))
            res[f"{arch}/opt"] = _specs(SH.opt_state_specs(p, st))
            for c in spec.shapes:
                res[f"{arch}/{c.name}/batch"] = _specs(
                    SH.recsys_batch_specs(cfg, mesh, c["batch"]))
    return res


def _keys() -> list:
    mesh = abstract_mesh(*tc.MESHES["2x2"])
    return sorted(port_rules(mesh))


KEYS = _keys()


@pytest.fixture(scope="module")
def rules(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharding") / "jax.json")
    proc = tc.start("sharding", out)
    port = {name: port_rules(abstract_mesh(*m))
            for name, m in tc.MESHES.items()}
    return port, tc.wait(proc, out)


@pytest.mark.parametrize("mesh", sorted(tc.MESHES))
def test_rule_keys_equal_jax(rules, mesh):
    port, jax = rules
    assert sorted(port[mesh]) == sorted(jax[mesh])


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("mesh", sorted(tc.MESHES))
def test_rule_equals_jax(rules, mesh, key):
    """One rule's tree on one mesh: the same leaf paths, each with the
    same spec."""
    port, jax = rules
    assert port[mesh][key] == jax[mesh][key]


def test_rules_take_the_mesh_sizes():
    """The same config splits on (2, 2) and stays whole where a dim does
    not divide (granite's vocab of 49,155 over 16 model shards)."""
    cfg = get_arch("granite-3-2b").model
    small = SH.lm_param_specs(cfg, abstract_mesh(*tc.MESHES["2x2"]))
    big = SH.lm_param_specs(cfg, abstract_mesh(*tc.MESHES["16x16"]))
    assert cfg.vocab % 16 != 0
    assert big["embed"] == Spec(None, None)
    assert small["layers"]["wq"] == Spec(None, "data", "model")
    assert SH.dp_axes(abstract_mesh(*tc.MESHES["2x16x16"])) == ("pod",
                                                                 "data")


def test_opt_state_specs_of_the_partitioned_mlperf_state():
    """The MLPerf split keeps no moments for the tables: the embed half
    holds a count only, the dense half's moments take the towers' specs,
    and every count replicates."""
    mesh = abstract_mesh(*tc.MESHES["16x16"])
    cfg = get_arch("deepfm").model
    p = SH.recsys_param_specs(cfg, mesh)
    st = _mlperf_opt().init(R.abstract_params(cfg))
    o = SH.opt_state_specs(p, st)
    assert o["embed"] == {"count": Spec()}
    assert o["dense"]["count"] == Spec()
    assert o["dense"]["mu"]["top_mlp"] == p["top_mlp"]
    assert "table" not in o["dense"]["mu"] and "fm_w" not in o["dense"]["nu"]
    assert o["dense"]["mu"]["fm_b"] == Spec()


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = abstract_mesh(*tc.MESHES["2x16x16"])
    assert SH.placements(mesh, Spec(("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert SH.placements(mesh, Spec(None, "model")) == (
        Replicate(), Replicate(), Shard(1))
    assert SH.placements(mesh, Spec()) == (Replicate(),) * 3
    assert SH.placements(mesh, Spec(None, ("pod", "data", "model"))) == (
        Shard(1),) * 3


@pytest.mark.parametrize("spec,match", [
    (Spec(("model", "data"), None), "not in the mesh's dim order"),
    (Spec("data", "data"), "shards two tensor dims"),
    (Spec("expert"), "no dim"),
])
def test_placements_raise(spec, match):
    with pytest.raises(ValueError, match=match):
        SH.placements(abstract_mesh(*tc.MESHES["2x16x16"]), spec)


def test_named_maps_a_tree():
    mesh = abstract_mesh(*tc.MESHES["2x2"])
    tree = SH.lm_batch_specs(mesh)
    named = SH.named(mesh, tree)
    assert set(named) == {"tokens", "labels"}
    assert named["tokens"] == SH.placements(mesh, tree["tokens"])


def test_spec_is_an_immutable_leaf():
    s = Spec("data", ["pod", "data"], None)
    assert tuple(s) == ("data", ("pod", "data"), None) and len(s) == 3
    assert s[1] == ("pod", "data") and s == Spec("data", ("pod", "data"),
                                                 None)
    with pytest.raises(AttributeError):
        s.dims = ()
    assert T.leaves({"a": s, "b": [Spec()]}) == [s, Spec()]


def test_abstract_mesh_runs_no_collective():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.mesh.shape == (2, 16, 16) and int(mesh.mesh.numel()) == 512
    with pytest.raises(TypeError, match="abstract mesh"):
        axis_group(mesh, "model")
    with pytest.raises(ValueError):
        abstract_mesh((2, 2), ("data",))
    assert torch.equal(mesh.mesh[1, 0, :3], torch.tensor([256, 257, 258]))
