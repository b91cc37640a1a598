"""The on-disk snapshot container (ARCHITECTURE.md "Persistence layering").

One ``.npz`` file holds a *versioned, self-describing* snapshot:

* ``__meta__`` — a UTF-8 JSON blob (stored as a uint8 array, the only way
  to put structured metadata inside an npz without pickling) carrying
  ``format_version``, the snapshot ``kind``, a free-form ``payload`` dict,
  and the **section table**: for every stored array its dtype, shape and
  CRC-32 checksum.
* ``{section}/{name}`` — the arrays themselves, grouped into named
  sections ("graph", "vectors", "store_sq8", "shard0/graph", ...).

Readers verify, in order: the meta blob parses, ``format_version`` is one
we understand (unknown versions are *rejected*, never guessed at), every
array named by the section table is present with the recorded dtype/shape,
and its bytes hash to the recorded checksum.  Failures raise typed errors
(:class:`SnapshotFormatError` / :class:`SnapshotChecksumError`) with the
offending section in the message — a truncated or bit-flipped snapshot
fails loudly at load, not as a corrupt search three layers up.

This module knows nothing about DEG semantics: ``persist/snapshot.py``
decides *what* goes into the sections; this layer owns the envelope.  It
is the JAX package's module, copied: both packages read and write the
same files.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

#: the one format this code writes; readers accept exactly the versions in
#: SUPPORTED_VERSIONS and reject everything else with a clear error.
FORMAT_VERSION = 1
SUPPORTED_VERSIONS = (1,)

_META_KEY = "__meta__"


class SnapshotFormatError(ValueError):
    """Structurally unusable snapshot (bad envelope, unknown version,
    missing section, dtype/shape mismatch)."""


class SnapshotChecksumError(SnapshotFormatError):
    """A section's bytes do not hash to the recorded checksum."""


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def write_snapshot(path, kind: str, sections: dict, payload: dict) -> None:
    """Write ``sections`` ({section: {name: ndarray}}) + ``payload`` (any
    JSON-able dict) to ``path`` as one compressed npz."""
    table: dict = {}
    arrays: dict = {}
    for sec, entries in sections.items():
        table[sec] = {}
        for name, arr in entries.items():
            arr = np.ascontiguousarray(arr)
            key = f"{sec}/{name}"
            arrays[key] = arr
            table[sec][name] = {
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "crc32": _crc32(arr),
            }
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "sections": table,
        "payload": payload,
    }
    blob = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # tmp + fsync + atomic rename: checkpoints overwrite their
    # predecessor, and a crash mid-write (or a power cut with the page
    # cache still dirty) must not destroy the only resumable snapshot
    # (the same commit protocol as train/checkpoint.py).  The directory
    # fsync makes the rename itself durable.
    path = os.fspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **{_META_KEY: blob}, **arrays)
            f.flush()
            os.fsync(f.fileno())
        from repro_torch.resilience import faults as _faults

        _faults.fire("snapshot.mid_save", path=path, tmp=tmp)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _fsync_dir(dirpath: str) -> None:
    fd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:        # some filesystems refuse directory fsync
        pass
    finally:
        os.close(fd)


def read_snapshot(path, expected_kind=None) -> tuple[dict, dict]:
    """Read + verify a snapshot.  Returns ``(payload, sections)`` where
    ``sections`` maps {section: {name: ndarray}}."""
    with np.load(path) as z:
        if _META_KEY not in z:
            raise SnapshotFormatError(
                f"{path}: not a repro snapshot (no {_META_KEY} entry); "
                "was this written by persist.write_snapshot?")
        try:
            meta = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SnapshotFormatError(f"{path}: corrupt meta blob: {e}")
        version = meta.get("format_version")
        if version not in SUPPORTED_VERSIONS:
            raise SnapshotFormatError(
                f"{path}: unknown snapshot format_version {version!r}; this "
                f"build reads versions {list(SUPPORTED_VERSIONS)}. Re-save "
                "the index with a matching build or upgrade this one.")
        if expected_kind is not None and meta.get("kind") != expected_kind:
            raise SnapshotFormatError(
                f"{path}: snapshot kind {meta.get('kind')!r}, "
                f"expected {expected_kind!r}")
        sections: dict = {}
        for sec, entries in meta["sections"].items():
            sections[sec] = {}
            for name, info in entries.items():
                key = f"{sec}/{name}"
                if key not in z:
                    raise SnapshotFormatError(
                        f"{path}: section array {key!r} named by the meta "
                        "table is missing from the archive")
                arr = z[key]
                if arr.dtype.str != info["dtype"] \
                        or list(arr.shape) != info["shape"]:
                    raise SnapshotFormatError(
                        f"{path}: {key!r} is {arr.dtype.str}{arr.shape}, "
                        f"meta table says {info['dtype']}"
                        f"{tuple(info['shape'])}")
                if _crc32(arr) != info["crc32"]:
                    raise SnapshotChecksumError(
                        f"{path}: checksum mismatch in section {key!r} "
                        "(truncated or corrupted snapshot)")
                sections[sec][name] = arr
    return meta["payload"], sections
