"""The port's ``analysis/roofline.py`` and ``analysis/report.py`` against
the JAX package's, on the CPU.

* Every model-flops function on every (arch, shape) cell of the JAX
  registry's ten architectures: the port's functions read only attributes
  of the config, so they take the JAX configs and the port's own configs
  of every family alike; equal to the last bit (the same float64
  arithmetic).
* ``kernel_tile_costs`` equal at ``KERNEL_DIMS``; ``kernel_roofline`` and
  ``attribute_kernel_time`` equal once the JAX module's TPU constants are
  set to the port's H100 figures (the two differ only in the constants).
* ``report.py``'s two tables and its ``main`` string-equal to JAX's on the
  same dry-run records.
"""
import json

import numpy as np
import pytest

import repro.configs as jconfigs
from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
import repro_torch.configs as tconfigs
from repro_torch.analysis import report as treport
from repro_torch.analysis import roofline as troof
from _torch_threads import _one_torch_thread  # noqa: F401

CELLS = jconfigs.all_cells()
# meta beside a config, as the JAX dry run records it
GNN_META = {"n_nodes": 2_708, "n_edges": 10_556}
DEG_META = {"family": "deg", "degree": 30, "dim": 128, "batch": 256,
            "n_shards": 4}


def _meta(spec, shape):
    meta = {"family": spec.family, "cfg": spec.model_for(shape)}
    if spec.family == "gnn":
        meta.update(GNN_META)
    return meta


def test_the_registry_has_ten_archs_and_forty_cells():
    assert len(jconfigs.list_archs()) == 10 and len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_jax(arch, shape):
    spec = jconfigs.get_arch(arch)
    cell = spec.cell(shape)
    meta = _meta(spec, shape)
    want = jroof.model_flops_for(meta, cell.kind, cell.dims)
    assert troof.model_flops_for(meta, cell.kind, cell.dims) == want
    assert want > 0
    # the port's own config: the same numbers
    tmeta = _meta(tconfigs.get_arch(arch), shape)
    assert troof.model_flops_for(tmeta, cell.kind, cell.dims) == want
    if spec.family == "recsys":
        assert troof.recsys_model_flops(
            tmeta["cfg"], cell.kind, cell["batch"],
            cell.dims.get("n_candidates", 0)) == want
    if spec.family == "lm":
        dims = cell.dims
        kind = cell.kind if cell.kind in ("train", "prefill") else "decode"
        assert troof.lm_model_flops(tmeta["cfg"], kind,
                                    dims["global_batch"],
                                    dims["seq_len"]) == want


@pytest.mark.parametrize("arch", [a for a in jconfigs.list_archs()])
def test_family_flops_functions_match_jax(arch):
    spec = jconfigs.get_arch(arch)
    cfg = spec.model
    if spec.family == "lm":
        for kind in ("train", "prefill", "decode"):
            assert troof.lm_model_flops(cfg, kind, 4, 512) == \
                jroof.lm_model_flops(cfg, kind, 4, 512)
    elif spec.family == "gnn":
        for train in (True, False):
            assert troof.egnn_model_flops(cfg, 300, 1200, train, 3) == \
                jroof.egnn_model_flops(cfg, 300, 1200, train, 3)
    else:
        for kind in ("recsys_train", "recsys_serve", "retrieval"):
            assert troof.recsys_model_flops(cfg, kind, 77, 1000) == \
                jroof.recsys_model_flops(cfg, kind, 77, 1000)


@pytest.mark.parametrize("hops", [1.0, 48.0, 97.5])
def test_deg_model_flops_match_jax(hops):
    assert troof.deg_model_flops(DEG_META, hops) == \
        jroof.deg_model_flops(DEG_META, hops)
    assert troof.model_flops_for(DEG_META, "search", {}, hops) == \
        jroof.model_flops_for(DEG_META, "search", {}, hops)
    assert troof.model_flops_for({"family": "none"}, "x", {}) == 0.0


def test_train_batch_flops_of_the_recsys_models():
    """The train_batch cell's step: 3 x the forward's flops a sample."""
    din = tconfigs.get_arch("din").model
    dcn = tconfigs.get_arch("dcn-v2").model
    f = troof.recsys_model_flops(din, "recsys_train", 65_536)
    assert f == pytest.approx(365.9e9, rel=1e-3)
    assert troof.recsys_model_flops(dcn, "recsys_train", 65_536) == \
        pytest.approx(1_008.5e9, rel=1e-3)
    # at the card's float32 peak (a vendor figure) the DIN step takes 5.5 ms
    assert f / troof.PEAK_FLOPS == pytest.approx(5.46e-3, rel=1e-2)


@pytest.fixture
def h100_jax(monkeypatch):
    """The JAX roofline with the port's constants in place of the TPU's."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.LINK_BW)


@pytest.mark.parametrize("name", sorted(troof.KERNEL_DIMS))
def test_kernel_costs_and_roofline_match_jax(name, h100_jax):
    assert troof.KERNEL_DIMS == jroof.KERNEL_DIMS
    dims = troof.KERNEL_DIMS[name]
    assert troof.kernel_tile_costs(name, **dims) == \
        jroof.kernel_tile_costs(name, **dims)
    assert troof.kernel_roofline(name, **dims).as_dict() == \
        jroof.kernel_roofline(name, **dims).as_dict()


def test_attribute_kernel_time_matches_jax(h100_jax):
    tiles = {"gather_dist": 4_800, "beam_merge": 160, "fused_hop": 40,
             "mrng_occlusion": 0, "gather_dist_q": 900}
    assert troof.attribute_kernel_time(0.125, tiles) == \
        jroof.attribute_kernel_time(0.125, tiles)
    out = troof.attribute_kernel_time(1.0, {"gather_dist": 0})
    assert out["gather_dist"]["fraction"] == 0.0


def test_roofline_uses_the_h100_figures():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (67e12, 3.35e12, 450e9)
    assert troof.HBM_BYTES_PER_S == troof.HBM_BW
    assert troof.FP32_OPS_PER_S == troof.PEAK_FLOPS
    r = troof.from_costs(67e12, 3.35e12 * 2, 450e9 * 3, model_flops=67e12)
    assert (r.t_comp, r.t_mem, r.t_coll) == (1.0, 2.0, 3.0)
    assert r.bottleneck == "collective" and r.step_time == 3.0
    assert r.useful_ratio == 1.0
    assert r.mfu_bound == pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="unknown kernel"):
        troof.kernel_tile_costs("no_such_kernel")


def test_bag_lookup_bwd_costs():
    """ids and weights, g, the distinct rows, grad_w and the dense
    grad_table, each once; 4 E flops a valid id."""
    c = troof.bag_lookup_bwd_costs(B=2, F=3, E=4, V=10, n_valid=5,
                                   n_rows=3)
    assert c == {"hbm_bytes": float(2 * 3 * 8 + 2 * 4 * 4 + 3 * 4 * 4
                                    + 2 * 3 * 4 + 10 * 4 * 4),
                 "flops": 80.0}
    c0 = troof.bag_lookup_bwd_costs(2, 3, 4, 10, 5, 3, weighted=False)
    assert c0["hbm_bytes"] == c["hbm_bytes"] - 24


def _records():
    roof = jroof.from_costs(3.2e15, 4.1e11, 2.0e10,
                            model_flops=2.9e15, devices=256).as_dict()
    ok = {"arch": "phi3-mini-3.8b", "shape": "train_4k", "status": "ok",
          "lower_s": 12.5, "compile_s": 88.25,
          "memory_analysis": {"argument_size_in_bytes": 3 * 2**30,
                              "temp_size_in_bytes": 7.5 * 2**30},
          "per_collective": {"all-reduce": 5e9, "all-gather": 2e9,
                             "reduce-scatter": 1e9,
                             "collective-permute": 1e8},
          "roofline": roof}
    out = [ok]
    for arch, shape in (("egnn", "full_graph_sm"), ("din", "serve_p99"),
                        ("gemma3-12b", "decode_32k"),
                        ("qwen3-moe-30b-a3b", "prefill_32k")):
        for bottleneck, t in (("collective", (1e-3, 2e-3, 5e-2)),
                              ("memory", (1e-3, 4e-2, 1e-4)),
                              ("compute", (9e-2, 1e-3, 1e-4))):
            rl = dict(roof, bottleneck=bottleneck, t_comp_s=t[0],
                      t_mem_s=t[1], t_coll_s=t[2])
            out.append(dict(ok, arch=arch, shape=shape, roofline=rl,
                            per_collective={} if arch == "din"
                            else ok["per_collective"]))
    out.append({"arch": "egnn", "shape": "molecule", "status": "skipped",
                "reason": "inapplicable on this mesh"})
    out.append({"arch": "mixtral-8x22b", "shape": "long_500k",
                "status": "error", "error": "RESOURCE_EXHAUSTED " * 10})
    out.append(dict(ok, variant="remat"))
    return out


def test_report_tables_match_jax():
    recs = _records()
    assert treport.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert treport.roofline_table(recs) == jreport.roofline_table(recs)
    for r in recs:
        if r["status"] == "ok":
            assert treport.suggest_fix(r) == jreport.suggest_fix(r)


def test_report_main_matches_jax(tmp_path, monkeypatch, capsys):
    root = tmp_path / "dryrun"
    for mesh in ("pod16x16", "debug2x2"):
        d = root / mesh
        d.mkdir(parents=True)
        for i, r in enumerate(_records()):
            (d / f"{i:02d}.json").write_text(json.dumps(r))
    assert set(treport.load(str(root))) == {"pod16x16", "debug2x2"}
    treport.main(["--root", str(root), "--out", str(tmp_path / "t.md")])
    monkeypatch.setattr("sys.argv", ["report", "--root", str(root),
                                     "--out", str(tmp_path / "j.md")])
    jreport.main()
    assert (tmp_path / "t.md").read_text() == (tmp_path / "j.md").read_text()
    treport.main(["--root", str(root)])
    assert capsys.readouterr().out.strip() == \
        (tmp_path / "t.md").read_text().strip()
    assert np.isfinite(troof.PEAK_FLOPS)
