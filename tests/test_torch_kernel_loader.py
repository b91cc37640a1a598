"""The kernel loader under threads: two first calls of one kernel, made at
once from two threads, build its source once and load it once."""
import ctypes
import threading
import time

from repro_torch.kernels import _build


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.repro_error_string = lambda code: b""
        self.entry = lambda *a: 0


def test_library_builds_and_loads_once_from_two_threads(monkeypatch,
                                                        tmp_path):
    target = tmp_path / "beam_search-0.so"
    calls, loads, inside = [], [], []
    overlap = []

    def fake_build_all(names=None):
        # a slow build: a second thread arriving meanwhile must wait
        if inside:
            overlap.append(names)
        inside.append(names)
        time.sleep(0.2)
        target.write_bytes(b"")
        calls.append(list(names))
        inside.pop()
        return 0.2

    def fake_cdll(path):
        loads.append(path)
        return _FakeLib(path)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "_target", lambda name: target)
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(2)
    got = []

    def first_call():
        start.wait()
        got.append(_build.function("beam_search", "entry", []))

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert calls == [["beam_search"]] and not overlap
    assert loads == [str(target)]
    assert len(got) == 2 and got[0] is got[1]
    assert _build.library("beam_search").path == str(target)


def test_build_all_holds_the_loader_lock(monkeypatch):
    """build_all runs under the same lock as library(): a thread that is
    loading keeps another thread's build out, and the other way round."""
    seen = []
    monkeypatch.setattr(_build, "_build_missing",
                        lambda names: seen.append(
                            _build._lock._is_owned()) or 0.0)
    _build.build_all(["beam_search"])
    assert seen == [True]
