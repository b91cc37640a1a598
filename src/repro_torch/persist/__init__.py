"""Versioned snapshot/restore of the full DEG index state, and the
crash-safe mutation journal between checkpoints.

* :mod:`repro_torch.persist.format` — the self-describing npz envelope
  (``format_version``, per-section CRC-32 checksums, typed load errors);
* :mod:`repro_torch.persist.snapshot` — one :class:`DEGIndex`: graph +
  vectors + materialized compressed stores + params + RNG/build counters
  + medoid cache, plus the mid-build checkpoint contract;
* :mod:`repro_torch.persist.wal` — CRC-framed append-only records,
  torn-tail truncation on read, ``recover(snapshot, wal)`` = bit-identical
  resume.

The file formats are the JAX package's: a snapshot or a journal either
package writes loads into the other.  ``DEGIndex.save/load`` and
``QueryEngine.from_snapshot`` funnel through the functions here.
"""
from .format import (FORMAT_VERSION, SUPPORTED_VERSIONS, SnapshotChecksumError,
                     SnapshotFormatError, read_snapshot, write_snapshot)
from .snapshot import load_index, save_index
from .wal import (WALCorruptionError, WALError, WALRecord, WALWriter,
                  read_wal, recover, replay_wal)

__all__ = [
    "FORMAT_VERSION", "SUPPORTED_VERSIONS",
    "SnapshotFormatError", "SnapshotChecksumError",
    "read_snapshot", "write_snapshot",
    "save_index", "load_index",
    "WALError", "WALCorruptionError", "WALRecord", "WALWriter",
    "read_wal", "replay_wal", "recover",
]
