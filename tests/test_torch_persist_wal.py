"""The port's mutation journal (``repro_torch.persist.wal``) and atomic
snapshot writes, as ``tests/test_persist_wal.py`` holds the JAX package's,
and a JAX snapshot plus a JAX journal recovered by the port.

The recovery contract: ``recover(snapshot, wal)`` is bit-identical to the
live index — graph rows, vectors, the RNG stream, the WAL cursor and
search results — at every record boundary.  Torn tails are truncated and
replay proceeds; complete-but-corrupt records raise typed errors.
"""
import os

import numpy as np
import pytest

from repro.core.build import DEGIndex as JDEGIndex
from repro.core.build import DEGParams as JDEGParams
from repro.persist import recover as j_recover
from repro.persist import save_index as j_save_index
from repro_torch.core.build import DEGIndex, DEGParams
from repro_torch.persist import (WALCorruptionError, WALError, WALWriter,
                                 load_index, read_wal, recover, replay_wal,
                                 save_index)
from repro_torch.persist.wal import FILE_MAGIC
from repro_torch.resilience import FaultInjected, FaultPlan
from _torch_threads import _one_torch_thread  # noqa: F401

DIM = 6
PARAMS = dict(degree=6, k_ext=12)


def _mk(capacity=96):
    return DEGIndex(DIM, DEGParams(**PARAMS), capacity=capacity,
                    device="cpu")


def _points(seed, k):
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(
        np.float32)


def _steps(idx):
    """A deterministic mutation script (add waves / remove / refine)."""
    return [
        lambda: idx.add(_points(1, 12), wave_size=4),
        lambda: idx.add(_points(2, 7), wave_size=3),
        lambda: idx.remove([3, 5]),
        lambda: idx.refine(6),               # seed drawn from the stream
        lambda: idx.add(_points(3, 5), wave_size=2),
        lambda: idx.refine(4, seed=77),      # explicit seed
        lambda: idx.remove([1]),
    ]


def _mutate(idx, upto):
    for step in _steps(idx)[:upto]:
        step()


def _recover(snap, wal):
    return recover(snap, wal, capacity=96, device="cpu")


def _sig(idx):
    n = idx.n
    res = idx.search_batch(_points(9, 5), k=4, eps=0.1)
    return (idx.builder.adjacency[:n].copy(), idx.builder.weights[:n].copy(),
            idx.vectors[:n].copy(), res.ids.numpy(), res.dists.numpy(),
            idx._rng.bit_generator.state, idx._wal_seq)


def _assert_same(a, b):
    sa, sb = _sig(a), _sig(b)
    for x, y in zip(sa[:5], sb[:5]):
        np.testing.assert_array_equal(x, y)
    assert sa[5] == sb[5], "RNG streams diverged"
    assert sa[6] == sb[6], "WAL cursors diverged"


def _journaled(tmp_path, tag):
    """A journaled index past its bootstrap, and a snapshot of it."""
    wal, snap = tmp_path / f"wal{tag}.log", tmp_path / f"snap{tag}.npz"
    idx = _mk()
    idx.enable_wal(wal)
    idx.add(_points(0, 10), wave_size=4)      # bootstrap + first wave
    save_index(idx, snap)                     # cursor mid-history
    return idx, snap, wal


def test_recovery_bit_identical_at_every_boundary(tmp_path):
    """recover(snapshot, wal) after each further unit equals the live
    index bit for bit at every record boundary."""
    idx, snap, wal = _journaled(tmp_path, "")
    for step in _steps(idx):
        step()
        _assert_same(idx, _recover(snap, wal))


def test_recovered_index_continues_identically(tmp_path):
    idx, snap, wal = _journaled(tmp_path, "")
    _mutate(idx, 4)
    rec = _recover(snap, wal)
    for z in (idx, rec):
        z.add(_points(5, 6), wave_size=3)
        z.refine(5)                           # both draw from their stream
    _assert_same(idx, rec)


def test_uninterrupted_reference_matches_replay(tmp_path):
    """The journal adds no semantics: an index running the same script
    with its own WAL lands in the recovered state."""
    a, snap, wal = _journaled(tmp_path, "a")
    b, _, _ = _journaled(tmp_path, "b")
    _mutate(a, 7)
    _mutate(b, 7)
    _assert_same(b, _recover(snap, wal))


def test_wal_seq_cursor_skips_pre_snapshot_records(tmp_path):
    wal, snap = tmp_path / "wal.log", tmp_path / "snap.npz"
    idx = _mk()
    idx.enable_wal(wal)
    idx.add(_points(0, 10), wave_size=4)
    _mutate(idx, 3)
    save_index(idx, snap)                     # cursor past several records
    n_before = idx.n
    idx.refine(3)                             # one post-snapshot record
    rec = _recover(snap, wal)
    _assert_same(idx, rec)
    assert rec.n == idx.n == n_before         # the prefix not re-applied


def test_torn_tail_truncated_and_writer_reattaches(tmp_path):
    wal = tmp_path / "wal.log"
    w = WALWriter(wal)
    w.append(0, "add", {"wave_size": 2}, {"points": _points(0, 4)})
    w.append(1, "refine", {"iterations": 3, "seed": 5, "drew": False}, {})
    w.close()
    good = os.path.getsize(wal)
    with open(wal, "ab") as f:                # crash mid-append: half a
        f.write(b"\x52\x4c\x41\x57\x07\x00")  # record header
    recs = read_wal(wal)
    assert [r.seq for r in recs] == [0, 1]
    assert os.path.getsize(wal) == good       # torn bytes truncated away
    w2 = WALWriter(wal)                       # the writer re-attaches
    w2.append(2, "refine", {"iterations": 1, "seed": 9, "drew": False}, {})
    w2.close()
    assert [r.seq for r in read_wal(wal)] == [0, 1, 2]


def test_torn_tail_mid_payload(tmp_path):
    wal = tmp_path / "wal.log"
    with WALWriter(wal) as w:
        w.append(0, "add", {"wave_size": 2}, {"points": _points(0, 4)})
    data = open(wal, "rb").read()
    with open(wal, "wb") as f:                # payload cut short
        f.write(data[:-7])
    assert read_wal(wal) == []
    assert os.path.getsize(wal) == len(FILE_MAGIC)


def test_corrupt_record_raises_typed(tmp_path):
    wal = tmp_path / "wal.log"
    with WALWriter(wal) as w:
        w.append(0, "add", {"wave_size": 2}, {"points": _points(0, 4)})
    data = bytearray(open(wal, "rb").read())
    data[-3] ^= 0xFF                          # bit rot inside the payload
    open(wal, "wb").write(bytes(data))
    with pytest.raises(WALCorruptionError, match="CRC mismatch"):
        read_wal(wal)
    assert open(wal, "rb").read() == bytes(data)   # not truncated


def test_bad_file_magic_raises(tmp_path):
    wal = tmp_path / "wal.log"
    open(wal, "wb").write(b"NOTAWAL0" + b"x" * 40)
    with pytest.raises(WALError, match="bad file magic"):
        read_wal(wal)
    with pytest.raises(WALError, match="bad file magic"):
        WALWriter(wal)


def test_bad_record_magic_raises(tmp_path):
    wal = tmp_path / "wal.log"
    with WALWriter(wal) as w:
        w.append(0, "refine", {"iterations": 1, "seed": 3, "drew": False},
                 {})
    data = bytearray(open(wal, "rb").read())
    data[len(FILE_MAGIC)] ^= 0xFF             # the record's magic
    open(wal, "wb").write(bytes(data))
    with pytest.raises(WALCorruptionError, match="bad record magic"):
        read_wal(wal)


def test_journal_gap_raises(tmp_path):
    wal = tmp_path / "wal.log"
    with WALWriter(wal) as w:
        w.append(0, "refine", {"iterations": 1, "seed": 3, "drew": False},
                 {})
        w.append(2, "refine", {"iterations": 1, "seed": 4, "drew": False},
                 {})
    idx = _mk()
    idx.add(_points(0, 10), wave_size=4)      # not journaled: cursor 0
    with pytest.raises(WALError, match="gap"):
        replay_wal(idx, wal)


def test_crash_at_record_boundary_via_fault_hook(tmp_path):
    """A kill at the WAL-append hook: the unit that never journaled is
    never applied, and recovery lands on the journaled prefix."""
    idx, snap, wal = _journaled(tmp_path, "")
    plan = FaultPlan().kill("wal.append", at=3)
    with plan:
        with pytest.raises(FaultInjected):
            _mutate(idx, 7)
    assert plan.counts() == {"wal.append": 1}
    _assert_same(idx, _recover(snap, wal))


def test_atomic_snapshot_crash_mid_save(tmp_path):
    snap = tmp_path / "snap.npz"
    idx = _mk()
    idx.add(_points(0, 12), wave_size=4)
    save_index(idx, snap)
    v1 = open(snap, "rb").read()
    idx.refine(3, seed=1)
    with FaultPlan().kill("snapshot.mid_save", at=1):
        with pytest.raises(FaultInjected):
            save_index(idx, snap)
    assert open(snap, "rb").read() == v1      # the predecessor untouched
    assert [p for p in os.listdir(tmp_path) if ".tmp" in p] == []
    assert load_index(snap, device="cpu").n == 12


def test_checkpoint_not_written_mid_journaled_op(tmp_path):
    wal, ckpt = tmp_path / "wal.log", tmp_path / "ckpt.npz"
    idx = _mk()
    idx.enable_wal(wal)
    idx.add(_points(0, 16), wave_size=4)
    idx.enable_checkpoints(ckpt, every_waves=1)   # tick on every boundary
    idx.refine(40)                            # 3 chunks: ticks suppressed
    assert not os.path.exists(ckpt)
    idx.remove([2])
    assert not os.path.exists(ckpt)
    idx.add(_points(4, 4), wave_size=2)       # wave boundaries still tick
    assert os.path.exists(ckpt)
    _assert_same(idx, _recover(ckpt, wal))


def test_replay_refuses_a_foreign_refine_seed(tmp_path):
    """A journal whose refine seed the restored stream does not re-draw
    belongs to another snapshot."""
    idx, snap, wal = _journaled(tmp_path, "")
    idx.refine(4)                             # seed drawn from the stream
    other = load_index(snap, device="cpu")
    other._rng.integers(0, 10)                # a diverged stream
    with pytest.raises(WALError, match="RNG stream diverged"):
        replay_wal(other, wal)


# ---------------------------------------------------------------------------
# across packages: a JAX snapshot and JAX journal, recovered by the port
# ---------------------------------------------------------------------------
def _edges(builder, n):
    """Each row's neighbors in ascending order and their weights in the
    same order: the graph edge for edge, whatever the slot order.

    Slot order is compared apart from the edges because the refinement
    of this journal meets a tie: Alg. 4 step 4a scores the candidates
    (s, n) = (16, 21) and (21, 16) of vertex 14, which add the same two
    edges, as ``gain + w(s, n) - ds - dist(v1, n)``, where ``ds`` is a
    search distance and ``dist`` the host's: the two sums are equal but
    for the last ulp of the search distances, in which the packages
    differ (dists agree at rtol 1e-6).  Each package then holds edges 16
    and 21 of vertex 14 in its own slot order, each weight taken from the
    other source."""
    adj = builder.adjacency[:n]
    order = np.argsort(adj, axis=1, kind="stable")
    return (np.take_along_axis(adj, order, 1),
            np.take_along_axis(builder.weights[:n], order, 1))


def test_port_recovers_a_jax_journal_like_jax(tmp_path):
    wal, snap = tmp_path / "jwal.log", tmp_path / "jsnap.npz"
    jidx = JDEGIndex(DIM, JDEGParams(**PARAMS), capacity=96)
    jidx.enable_wal(wal)
    jidx.add(_points(0, 10), wave_size=4)
    j_save_index(jidx, snap)
    jidx.add(_points(1, 12), wave_size=4)
    jidx.refine(6)                            # seed drawn from the stream
    jidx.add(_points(2, 7), wave_size=3)
    jidx.remove([3, 5])
    jidx.refine(4, seed=77)
    want = j_recover(snap, wal, capacity=96)
    got = recover(snap, wal, capacity=96, device="cpu")
    n = want.n
    assert got.n == n == jidx.n
    got_nbrs, got_w = _edges(got.builder, n)
    want_nbrs, want_w = _edges(want.builder, n)
    np.testing.assert_array_equal(got_nbrs, want_nbrs)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
    np.testing.assert_array_equal(got.vectors[:n], want.vectors[:n])
    assert got._wal_seq == want._wal_seq == jidx._wal_seq
    assert got._rng.bit_generator.state == want._rng.bit_generator.state
