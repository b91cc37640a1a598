"""Crash-safe mutation journal (write-ahead log) for :class:`DEGIndex`,
copied from the JAX package (the journal format is shared: a WAL either
package writes replays in the other).

Checkpoints only capture wave boundaries; any ``add``/``remove``/
``refine`` issued between ``enable_checkpoints`` ticks was simply lost
on crash.  The WAL closes that window: with ``index.enable_wal(path)``
every mutation *unit* is journaled **before** it is applied, so recovery
is::

    idx = load_index(snapshot)          # restores graph + RNG stream
    replay_wal(idx, wal_path)           # re-applies ops >= snapshot cursor

and the result is bit-identical to the uninterrupted build — the RNG
stream is part of the snapshot payload, every mutation is deterministic
given the stream (deletes derive their RNG from the vertex id, a
``refine`` under WAL resolves its seed by drawing from the persisted
stream), and the journal replays in admission order.

On-disk format (little-endian)::

    file   := header record*
    header := b"DEGWAL01"                              (8 bytes)
    record := magic:u32  seq:u64  op:u8  len:u32  crc:u32  payload[len]

``payload`` is an npz (the same container as snapshots) holding a
``__meta__`` JSON blob plus the op's arrays, and ``crc`` is the CRC-32
of the payload bytes.  Failure modes are distinguished deliberately:

* an **incomplete trailing record** (the process died mid-append) is a
  *torn tail* — expected after a crash; :func:`read_wal` truncates it
  and replay proceeds with the complete prefix;
* a **complete record whose payload fails its CRC** (bit rot, a seek
  scribble) is *corruption* — :class:`WALCorruptionError`, never
  silently skipped.

Ops journaled (one record per *unit* so mid-``add`` checkpoints see a
consistent cursor): ``add`` — one bootstrap take or one insert wave
(points array + wave_size); ``remove`` — the id list + refine_after;
``refine`` — iterations + resolved seed; ``epoch_publish`` — an epoch
boundary marker (epoch number, n, builder generation, quarantine set)
written by ``DEGIndex.publish()``.

Publish markers change recovery semantics: when the journal contains
``epoch_publish`` records past the snapshot cursor, :func:`replay_wal`
stops at the **last** one and truncates the unpublished tail — readers of
a publishing index only ever observed published epochs, so recovering to
a half-applied mutation batch beyond the last publish would materialize a
state no reader (and no result the service returned) ever saw.  Journals
without publish markers (the pre-epoch format, and non-serving builds)
replay in full, unchanged.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.resilience import faults as _faults

FILE_MAGIC = b"DEGWAL01"
_REC_MAGIC = 0x57414C52            # "RLAW" little-endian = b"RLAW"
_REC_HEADER = struct.Struct("<IQBII")   # magic, seq, op, len, crc
_META_KEY = "__meta__"

OPS = {"add": 1, "remove": 2, "refine": 3, "epoch_publish": 4}
_OP_NAMES = {v: k for k, v in OPS.items()}


class WALError(ValueError):
    """Structural WAL problem (bad header, op/seq mismatch on replay)."""


class WALCorruptionError(WALError):
    """A complete record's payload fails its CRC — data corruption, as
    opposed to the expected torn tail of a crash mid-append."""


@dataclasses.dataclass
class WALRecord:
    seq: int
    op: str
    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]
    end_off: int = 0        # file offset just past this record (replay
    #                         truncates the unpublished tail at this point)


def _encode_payload(meta: Dict[str, Any],
                    arrays: Dict[str, np.ndarray]) -> bytes:
    blob = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **{_META_KEY: blob}, **arrays)
    return buf.getvalue()


def _decode_payload(data: bytes) -> tuple[Dict[str, Any],
                                          Dict[str, np.ndarray]]:
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return meta, arrays


class WALWriter:
    """Append-only journal writer.  ``sync=True`` (the default) fsyncs
    every append — a record the caller saw ``append`` return for
    survives the process.  Attaching to an existing journal validates
    the header and appends after the last record."""

    def __init__(self, path, sync: bool = True):
        self.path = os.fspath(path)
        self.sync = sync
        exists = os.path.exists(self.path) and \
            os.path.getsize(self.path) > 0
        if exists:
            with open(self.path, "rb") as f:
                head = f.read(len(FILE_MAGIC))
            if head != FILE_MAGIC:
                raise WALError(
                    f"{self.path}: not a DEG WAL (bad file magic)")
        self._f = open(self.path, "ab")
        if not exists:
            self._f.write(FILE_MAGIC)
            self._flush()

    def append(self, seq: int, op: str,
               meta: Optional[Dict[str, Any]] = None,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        payload = _encode_payload(meta or {}, arrays or {})
        _faults.fire("wal.append", seq=seq, op=op, path=self.path)
        self._f.write(_REC_HEADER.pack(
            _REC_MAGIC, seq, OPS[op], len(payload),
            zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._flush()

    def _flush(self) -> None:
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._flush()
            self._f.close()

    def __enter__(self) -> "WALWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_wal(path, *, truncate_torn: bool = True) -> List[WALRecord]:
    """Read every complete record.  A torn tail (crash mid-append) is
    truncated in place when ``truncate_torn`` so a writer can re-attach;
    a complete-but-CRC-failing record raises
    :class:`WALCorruptionError`."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if len(data) == 0:
        return []                      # crashed before the header landed
    if len(data) < len(FILE_MAGIC):
        return _torn(path, 0, truncate_torn)
    if data[: len(FILE_MAGIC)] != FILE_MAGIC:
        raise WALError(f"{path}: not a DEG WAL (bad file magic)")
    records: List[WALRecord] = []
    off = len(FILE_MAGIC)
    while off < len(data):
        if off + _REC_HEADER.size > len(data):
            return records + _torn(path, off, truncate_torn)
        magic, seq, op_code, length, crc = _REC_HEADER.unpack_from(data, off)
        if magic != _REC_MAGIC:
            raise WALCorruptionError(
                f"{path}: bad record magic at offset {off} "
                "(overwritten or corrupted journal)")
        body_start = off + _REC_HEADER.size
        if body_start + length > len(data):
            return records + _torn(path, off, truncate_torn)
        payload = data[body_start: body_start + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise WALCorruptionError(
                f"{path}: CRC mismatch in record seq={seq} at offset "
                f"{off} — corrupted record (not a torn tail)")
        if op_code not in _OP_NAMES:
            raise WALCorruptionError(
                f"{path}: unknown op code {op_code} in record seq={seq}")
        meta, arrays = _decode_payload(payload)
        records.append(WALRecord(seq=seq, op=_OP_NAMES[op_code],
                                 meta=meta, arrays=arrays,
                                 end_off=body_start + length))
        off = body_start + length
    return records


def _torn(path: str, good_end: int, truncate: bool) -> list:
    if truncate:
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return []


def replay_wal(index, path, *,
               to_last_publish: Optional[bool] = None) -> int:
    """Re-apply journaled ops past the index's snapshot cursor.

    Records with ``seq`` below ``index._wal_seq`` predate the snapshot
    and are skipped; the rest must be contiguous from the cursor (a gap
    means snapshot and journal don't belong together).  Each op runs
    through the index's *public* mutation methods with the replay guard
    set, so the exact build code paths execute — the guard verifies each
    op against its record (op kind and, for ``refine``, the re-drawn
    seed) instead of re-appending it.  Returns the number of ops
    applied.

    ``to_last_publish`` controls the crash-consistent-publish contract:
    ``None`` (auto, the default) stops at the last ``epoch_publish``
    record **iff any exists past the cursor** and truncates the journal
    tail beyond it, so recovery lands exactly on the last state a reader
    could have observed and re-enabled logging continues from a matching
    cursor.  ``False`` forces a full replay (pre-epoch behavior);
    ``True`` demands a publish marker and raises if none is found past
    the cursor.  Each publish marker is verified against the replayed
    state (``n`` must match) — a mismatch means the snapshot and journal
    diverged."""
    records = read_wal(path, truncate_torn=True)
    start_seq = index._wal_seq
    pub_idx = None
    for i, rec in enumerate(records):
        if rec.op == "epoch_publish" and rec.seq >= start_seq:
            pub_idx = i
    if to_last_publish is None:
        to_last_publish = pub_idx is not None
    elif to_last_publish and pub_idx is None:
        raise WALError(
            f"{path}: to_last_publish=True but no epoch_publish record "
            f"past cursor {start_seq}")
    stop = pub_idx if to_last_publish else len(records) - 1
    applied = 0
    for rec in records[: stop + 1] if stop is not None else records:
        if rec.seq < index._wal_seq:
            continue
        if rec.seq != index._wal_seq:
            raise WALError(
                f"{path}: journal gap — snapshot cursor is "
                f"{index._wal_seq} but next record is seq={rec.seq}; "
                "this WAL does not continue that snapshot")
        if rec.op == "epoch_publish":
            if int(rec.meta["n"]) != index.n:
                raise WALError(
                    f"{path}: epoch_publish seq={rec.seq} expects "
                    f"n={rec.meta['n']} but replay reached n={index.n} — "
                    "snapshot and journal diverged")
            index._wal_seq += 1
            applied += 1
            continue
        index._wal_replay = rec
        try:
            if rec.op == "add":
                index.add(rec.arrays["points"],
                          wave_size=int(rec.meta["wave_size"]))
            elif rec.op == "remove":
                index.remove([int(x) for x in rec.arrays["ids"]],
                             refine_after=int(rec.meta["refine_after"]))
            else:                      # "refine"
                index.refine(int(rec.meta["iterations"]),
                             seed=None if rec.meta["drew"]
                             else rec.meta["seed"])
        finally:
            index._wal_replay = None
        applied += 1
    if to_last_publish and pub_idx is not None \
            and pub_idx < len(records) - 1:
        # discard the unpublished tail: no reader ever saw those
        # mutations, and a re-enabled writer must append at the
        # recovered cursor without seq collisions
        with open(os.fspath(path), "r+b") as f:
            f.truncate(records[pub_idx].end_off)
    return applied


def recover(snapshot_path, wal_path, params: Optional[object] = None,
            capacity: Optional[int] = None,
            to_last_publish: Optional[bool] = None, device="cuda"):
    """``load_index(snapshot) + replay_wal(wal)`` in one call, on
    ``device``.  The WAL (if present) is replayed and re-enabled on the
    returned index, so mutation logging continues at the recovered
    cursor.  When the journal holds ``epoch_publish`` markers, recovery
    lands exactly on the last published epoch (see :func:`replay_wal`);
    ``to_last_publish`` forces either behavior."""
    from .snapshot import load_index

    index = load_index(snapshot_path, params=params, capacity=capacity,
                       device=device)
    if wal_path is not None and os.path.exists(wal_path):
        replay_wal(index, wal_path, to_last_publish=to_last_publish)
        index.enable_wal(wal_path)
    return index
