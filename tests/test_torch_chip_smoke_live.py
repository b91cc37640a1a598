"""A rehearsal of ``chip_smoke.py``'s phase 10 on the CPU at n=800: live
mutation under serving (epochs, the scrubber, the writer thread), the
async engine with its degradation ladder and deadlines, and the
launchers, on a snapshot of the rehearsal's index.  The card-only pieces
are replaced as in ``tests/test_torch_chip_smoke.py``; every expected
launch count reads 0 on the CPU."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: F401

N, N_QUERIES, BATCH = 800, 64, 32
# a writer tick's sizes here; on the CPU a refined vertex of the 192-wide
# rows costs seconds (single-lane searches on the plain host loop)
SMALL = dict(n_insert=8, n_remove=4, n_refine=1)


def _no_launches(kernel, got, want, what):
    assert got == 0, f"{got} {kernel} launches on the CPU"


@pytest.fixture(scope="module")
def rehearsal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: None)
        mp.setattr(cs, "expect_launches", _no_launches)
        yield mp


@pytest.fixture(scope="module")
def saved(rehearsal, tmp_path_factory):
    """The rehearsal's index saved as phase 9 saves it, its queries and
    its "classic" ids (phase 4's)."""
    idx, _, queries, _ = cs.build_phase(N, N_QUERIES, "cpu")
    ids = cs.serve_tensors(idx, queries, "classic", batch=BATCH)["ids"]
    tmp = tmp_path_factory.mktemp("phase10")
    path = str(tmp / "audio.npz")
    idx.save(path)
    return path, queries, {"classic": ids.numpy()}, tmp


def _load(path):
    from repro_torch.core.build import DEGIndex

    return DEGIndex.load(path, device="cpu")


def test_phase10_epochs_then_scrub(saved):
    path, queries, results, _ = saved
    idx = _load(path)
    out = cs.epoch_phase(idx, queries, results, queries[::-1][:8], "cpu",
                         batch=BATCH, **SMALL)
    assert out["publish_ms"] >= 0 and out["epoch_bytes"] > 0
    assert idx._epochs.live_epochs() == [idx._epochs.current.epoch]
    assert idx.n == N + 8 - 4
    s = cs.scrub_phase(idx, queries, "cpu", batch=BATCH, n_corrupt=8,
                       refine_repaired=False)
    assert s["quarantined"] >= 1 and s["summary"]["unrepaired"] == 0
    assert s["recall"] >= cs.RECALL_FLOOR and not idx.quarantine


def test_phase10_scrub_catches_a_leak(saved, monkeypatch):
    """The flush between quarantine and re-admission must hide every
    quarantined id: an engine that forgets the quarantine is refused."""
    path, queries, _, _ = saved
    idx = _load(path)
    idx.enable_publishing()
    from repro_torch.serving import engine as eng_mod

    real = eng_mod.QueryEngine.flush

    def forgetful(self):
        view = self.index._epochs.current
        q, view.quarantine = view.quarantine, ()
        try:
            return real(self)
        finally:
            view.quarantine = q

    monkeypatch.setattr(eng_mod.QueryEngine, "flush", forgetful)
    with pytest.raises(AssertionError, match="the flush between"):
        cs.scrub_phase(idx, queries, "cpu", batch=BATCH, n_corrupt=8,
                       refine_repaired=False)


def test_phase10_async(saved):
    path, queries, results, tmp = saved
    out = cs.async_phase(path, queries, results, "cpu", batch=BATCH,
                         n_partial=8, tmp=str(tmp))
    assert out["rungs"] == ["base", "slim-beam", "hop-cap", "sq8"]
    assert out["flushes"] >= 2 and out["p99_ms"] >= out["p50_ms"] > 0
    assert set(out["buckets"]) <= {8, 16, 32}


def test_phase10_live_serving(saved):
    path, queries, _, _ = saved
    idx = _load(path)
    idx.enable_publishing()
    out = cs.live_serve_phase(idx, queries, queries[::-1][:16], "cpu",
                              batch=BATCH, ticks=2, min_rounds=2, **SMALL)
    assert out["torn"] == 0 and out["published"] == 2
    assert out["results"] >= 2 * BATCH      # at least min_rounds rounds
    assert idx.n == N + 2 * (8 - 4)


def test_phase10_live_serving_refuses_a_torn_read(saved, monkeypatch):
    """A served result that its epoch does not replay is a torn read."""
    path, queries, _, _ = saved
    idx = _load(path)
    idx.enable_publishing()
    real = cs._direct_flush

    def off_by_one(view, cfg, qs, budget):
        ids, dists, *rest = real(view, cfg, qs, budget)
        return (ids, dists + np.float32(1.0), *rest)

    monkeypatch.setattr(cs, "_direct_flush", off_by_one)
    with pytest.raises(AssertionError, match="torn reads"):
        cs.live_serve_phase(idx, queries, queries[::-1][:8], "cpu",
                            batch=BATCH, ticks=1, min_rounds=1, **SMALL)


def test_phase10_live_serving_refuses_a_failing_scrubber(saved, monkeypatch):
    """A scrub pass that raises in the scrubber's thread is counted there,
    and the phase fails on the count."""
    from repro_torch.serving.scrub import IntegrityScrubber

    path, queries, _, _ = saved
    idx = _load(path)
    idx.enable_publishing()

    def broken(self):
        raise RuntimeError("a pass that fails")

    monkeypatch.setattr(IntegrityScrubber, "run_pass", broken)
    with pytest.raises(AssertionError, match="scrubber"):
        cs.live_serve_phase(idx, queries, queries[::-1][:8], "cpu",
                            batch=BATCH, ticks=1, min_rounds=1, **SMALL)


@pytest.fixture(scope="module")
def small_snapshot(tmp_path_factory):
    """A dim-8 snapshot from ``launch.build_index``: the serve launcher's
    subprocess refines and repairs on it in seconds on the CPU."""
    from repro_torch.launch import build_index

    path = str(tmp_path_factory.mktemp("launch") / "small.npz")
    build_index.main(["--n", "600", "--dim", "8", "--degree", "8",
                      "--k-ext", "16", "--out", path, "--device", "cpu"])
    return path


def test_phase10_launchers(rehearsal, small_snapshot, tmp_path):
    out = cs.launcher_phase(small_snapshot, "cpu", str(tmp_path), queries=32,
                            n_build=600)
    assert out["serve_s"] > 0 and out["build_s"] > 0


_SERVE_OK = {
    "resilience:": "resilience: served=32 shed=0 invalid=0 crashed=0 "
                   "degraded=0 restarts=0 status=ok",
    "refine:": "refine: ticks=2 errors=0",
    "scrub:": "scrub: passes=2 audited=1200 quarantined=8 repaired=8 "
              "readmitted=8 unrepaired=0 crashes=0 errors=0 epoch=4",
}


@pytest.mark.parametrize("key,line", [
    ("refine:", "refine: ticks=0 errors=0"),
    ("refine:", "refine: ticks=3 errors=1"),
    ("refine:", None),
    ("scrub:", "scrub: passes=2 audited=1200 quarantined=8 repaired=8 "
               "readmitted=8 unrepaired=0 crashes=0 errors=1 epoch=4"),
    ("scrub:", "scrub: passes=2 audited=1200 quarantined=8 repaired=8 "
               "readmitted=8 unrepaired=0 crashes=1 errors=0 epoch=4"),
])
def test_phase10_launcher_refuses_a_failing_thread(rehearsal, tmp_path,
                                                   monkeypatch, key, line):
    """The serve subprocess's writer and scrubber threads count their
    failures on its summary lines; a count other than a clean one (or a
    writer that never ticked) fails the phase."""
    import subprocess

    lines = dict(_SERVE_OK, **{key: line})
    out = "\n".join(ln for ln in [*lines.values(), "invariants: ok=True",
                                   "served 32 queries"] if ln) + "\n"
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **kw:
                        subprocess.CompletedProcess(a, 0, out, ""))
    with pytest.raises(AssertionError, match="launch.serve"):
        cs.launcher_phase("unused.npz", "cpu", str(tmp_path), queries=8,
                          n_build=600)


def test_phase10_launcher_failure_raises(rehearsal, tmp_path):
    with pytest.raises(AssertionError, match="launch.serve exited"):
        cs.launcher_phase(str(tmp_path / "missing.npz"), "cpu",
                          str(tmp_path), queries=8, n_build=600)


def test_phase10_whole_wires_its_pieces(saved, monkeypatch):
    """``live_phase`` as phase 9 calls it: each piece gets the snapshot,
    its own held-out rows (the last queries, each inserted once) and the
    sizes; the pieces themselves are rehearsed above."""
    path, queries, results, tmp = saved
    calls = {}

    def rec(name, ret=None):
        def fn(*a, **kw):
            calls[name] = (a, kw)
            return ret or {}
        return fn

    for name in ("epoch_phase", "scrub_phase", "async_phase",
                 "live_serve_phase", "launcher_phase"):
        monkeypatch.setattr(cs, name, rec(name))
    out = cs.live_phase(path, queries, results, "cpu", tmp=str(tmp),
                        batch=BATCH, ticks=3, n_corrupt=16, n_partial=8,
                        launcher_queries=32, n_build=600, **SMALL)
    assert set(out) == {"epochs", "scrub", "async", "live", "launch"}
    a, kw = calls["epoch_phase"]
    idx = a[0]
    assert idx.n == N and a[2] is results and kw["n_insert"] == 8
    first = a[3]
    a, kw = calls["live_serve_phase"]
    assert a[0] is idx and kw["ticks"] == 3 and kw["n_refine"] == 1
    later = a[2]
    held = np.concatenate([first, later])
    assert held.shape == (8 * 4, queries.shape[1]) and held.dtype == np.float32
    # midpoints of seeded pairs of the index's rows, each inserted once
    pairs = np.random.default_rng(10).integers(0, N, size=(2, 32))
    want = 0.5 * (idx.vectors[pairs[0]] + idx.vectors[pairs[1]])
    np.testing.assert_array_equal(held, want.astype(np.float32))
    assert len(np.unique(held, axis=0)) == 32
    assert calls["scrub_phase"][1]["n_corrupt"] == 16
    assert calls["async_phase"][0][0] == path
    assert calls["launcher_phase"][1] == {"queries": 32, "n_build": 600}


def test_phase10_is_in_the_docstring_and_main():
    doc = " ".join(cs.__doc__.split())
    assert "10. (inside phase 9's temporary directory" in doc
    for part in ("10a. the restored index", "10b. corrupt_adjacency",
                 "10c. a fresh restore", "10d. the \"classic\"",
                 "10e. python -m repro_torch.launch.serve"):
        assert part in doc, part
    src = open(cs.__file__).read()
    assert "live = live_phase(path, queries, results, device, count" in src
