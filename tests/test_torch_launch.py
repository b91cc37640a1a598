"""The port's launchers on the CPU at a small size: ``launch/build_index``
writes a snapshot both packages load, and ``launch/serve`` serves it (or a
fresh build) through the sync and async engines with the live-mutation
and resilience flags, ending with its greppable summary lines."""
from __future__ import annotations

import re

import numpy as np
import pytest

from repro.core.build import DEGIndex as JDEGIndex
from repro_torch.core.build import DEGIndex
from repro_torch.launch import build_index, serve
from _torch_threads import _one_torch_thread  # noqa: F401

SMALL = ["--n", "600", "--dim", "8", "--degree", "8", "--device", "cpu"]


def _line(out, prefix):
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert lines, f"no {prefix!r} line in:\n{out}"
    return lines[-1]


def _fields(line):
    return {k: v for k, v in re.findall(r"(\w+)=(\S+)", line)}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("launch") / "idx.npz"
    build_index.main(SMALL + ["--k-ext", "16", "--out", str(path)])
    return path


def test_build_index_out_loads_in_both_packages(snapshot, capsys):
    tidx = DEGIndex.load(snapshot, device="cpu")
    jidx = JDEGIndex.load(snapshot)
    assert tidx.n == jidx.n == 600 and tidx.dim == 8
    np.testing.assert_array_equal(tidx.builder.adjacency[: tidx.n],
                                  jidx.builder.adjacency[: jidx.n])
    np.testing.assert_array_equal(tidx.vectors[: tidx.n],
                                  jidx.vectors[: jidx.n])
    q = tidx.vectors[:5] + 0.01
    np.testing.assert_array_equal(
        tidx.search_batch(q, k=5).ids.numpy(),
        np.asarray(jidx.search_batch(q, k=5).ids))


def test_build_index_reports(capsys, tmp_path):
    build_index.main(SMALL + ["--k-ext", "16", "--refine", "20",
                              "--out", str(tmp_path / "b.npz")])
    out = capsys.readouterr().out
    rec = float(re.search(r"recall@10 ([0-9.]+)", out).group(1))
    assert rec >= 0.85
    assert "refined 20 iterations" in out
    assert f"saved index snapshot to {tmp_path / 'b.npz'}" in out


def test_serve_sync_engine(capsys, tmp_path):
    serve.main(SMALL + ["--queries", "64", "--batch", "16",
                        "--build-refine", "20", "--insert-every", "16",
                        "--refine-budget", "2", "--explore-sessions", "2",
                        "--save-index", str(tmp_path / "s.npz")])
    out = capsys.readouterr().out
    line = _line(out, "served 64 queries")
    assert float(re.search(r"recall@10=([0-9.]+)", line).group(1)) >= 0.85
    assert "4 inserts" in line
    assert "ran 2 exploration sessions (4 hops each, exclusion verified)" in out
    assert DEGIndex.load(tmp_path / "s.npz", device="cpu").n == 604


def test_serve_async_live_mutation(snapshot, capsys):
    """The live-mutation flags on a warm start: publishing, injected
    damage the scrubber heals, a refining writer, and the summary lines."""
    serve.main(["--index", str(snapshot), "--engine", "async", "--warmup",
                "--refine-while-serving", "4", "--scrub-every", "0.2",
                "--inject-corruption", "8", "--queries", "64",
                "--batch", "16", "--deadline-ms", "-1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epochs: publication enabled (epoch 0)" in out
    assert _line(out, "corruption: flipped 8 adjacency entries")
    assert _line(out, "warmup: ").endswith("(buckets [8, 16])")
    res = _fields(_line(out, "resilience:"))
    assert res["served"] == "64" and res["crashed"] == "0"
    assert res["status"] == "ok"
    scrub = _fields(_line(out, "scrub:"))
    assert int(scrub["quarantined"]) > 0 and scrub["unrepaired"] == "0"
    assert scrub["repaired"] == scrub["quarantined"]
    assert int(scrub["epoch"]) >= 2
    assert _line(out, "invariants:") == "invariants: ok=True"
    refine = _fields(_line(out, "refine: ticks"))
    assert int(refine["ticks"]) >= 1 and refine["errors"] == "0"
    served = _line(out, "served 64 queries")
    assert " 0 partial " in served


def test_serve_async_resilience_flags(snapshot, capsys, tmp_path):
    from repro_torch.resilience import clear_faults

    try:
        serve.main(["--index", str(snapshot), "--engine", "async",
                    "--queries", "48", "--batch", "8", "--max-queue", "64",
                    "--degrade", "--faults",
                    "scheduler.dispatch:delay=0.0*2",
                    "--wal", str(tmp_path / "m.wal"), "--metrics-port", "0",
                    "--trace-sample", "0.5", "--query-log",
                    str(tmp_path / "q.jsonl"), "--device", "cpu"])
    finally:
        clear_faults()                 # the plan is process-wide
    out = capsys.readouterr().out
    assert "faults: installed plan 'scheduler.dispatch:delay=0.0*2'" in out
    assert _line(out, "wal: journaling mutations to")
    assert re.search(r"metrics: http://127\.0\.0\.1:\d+/metrics", out)
    res = _fields(_line(out, "resilience:"))
    assert int(res["served"]) + int(res["shed"]) == 48
    assert res["invalid"] == "0" and res["crashed"] == "0"
    from repro_torch.obs import read_query_log

    assert len(read_query_log(str(tmp_path / "q.jsonl"))) == \
        int(res["served"]) // 2


def test_serve_loads_a_legacy_archive(snapshot, capsys, tmp_path):
    """The legacy build_index archive (adjacency/weights/vectors/degree)
    still warm-starts."""
    idx = DEGIndex.load(snapshot, device="cpu")
    b = idx.builder
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, adjacency=b.adjacency[: b.n], weights=b.weights[: b.n],
             vectors=idx.vectors[: idx.n], degree=b.degree)
    loaded = serve._load_index(str(legacy), "cpu")
    np.testing.assert_array_equal(loaded.builder.adjacency[: loaded.n],
                                  b.adjacency[: b.n])
    serve.main(["--index", str(legacy), "--queries", "32", "--batch", "16",
                "--explore-sessions", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert float(re.search(r"recall@10=([0-9.]+)",
                           _line(out, "served 32 queries")).group(1)) >= 0.85


def test_train_fails_then_resumes(capsys, tmp_path):
    """``launch.train``: a run with ``--fail-at 12`` raises after step 12,
    before its checkpoint; the rerun resumes after the step-10 checkpoint
    (at step 11) and its last loss is below its first.  The batches are
    256 samples: at the default 16, one batch's BCE noise is larger than
    what 19 steps of the warm-up learn."""
    from repro_torch.launch import train
    from repro_torch.train.loop import InjectedFailure

    args = ["--arch", "din", "--steps", "30", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
            "--batch", "256"]
    with pytest.raises(InjectedFailure, match="step 12"):
        train.main(args + ["--fail-at", "12"])
    capsys.readouterr()
    train.main(args)
    out = capsys.readouterr().out
    assert "[loop] resumed from step 10" in out
    m = re.search(r"final loss: ([0-9.]+) \(first: ([0-9.]+)\)", out)
    assert float(m.group(1)) < float(m.group(2))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "egnn"])
def test_train_names_the_roadmap_item_for_other_families(arch, capsys):
    """An LM arch trains since the LM slice (its reduced config, --seq
    tokens a sequence) and EGNN since the EGNN slice (subgraphs of --batch
    seeds); an unknown name raises."""
    from repro_torch.launch import train

    train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "8"])
    assert re.search(r"final loss: [0-9.]+ \(first: [0-9.]+\)",
                     capsys.readouterr().out)
    with pytest.raises(ValueError, match="unknown arch"):
        train.main(["--arch", "no-such-arch", "--device", "cpu"])


def test_train_batch_trainer_builds_the_mlperf_split():
    """The train_batch cell's trainer on a reduced config: SGD state for
    the table alone, AdamW moments for the towers, and batches made once
    per step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_batch_trainer

    step, params, state, batch_fn = train_batch_trainer(
        "din", device="cpu", batch=32, cfg=get_arch("din").reduced())
    assert set(state) == {"embed", "dense"}
    assert set(state["embed"]) == {"count"}
    assert "table" not in state["dense"]["mu"]
    b = batch_fn(0)
    assert b["hist"].shape == (32, 10) and batch_fn(0) is b
    assert set(batch_fn.host_s) == {0}
    table = params["table"].clone()
    (params, state), m = step(params, state, b)
    assert torch.isfinite(m["loss"]) and not torch.equal(params["table"],
                                                         table)
    assert int(state["embed"]["count"]) == int(state["dense"]["count"]) == 1
