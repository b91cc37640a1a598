"""Snapshot/restore of a :class:`repro_torch.distributed.index.ShardedDEG`,
in the JAX package's ``sharded_deg`` format (either package reads the
other's files).

One npz holds a **manifest** (shard count, params, attached codec, per-shard
payloads) plus the full per-shard sections of ``persist/snapshot.py`` under
``shard{i}/...`` prefixes: each sub-DEG round-trips exactly like a single
index, including its build RNG stream.  The manifest's ``hop_backend``
keeps the JAX names, as a single snapshot's does.

Restore semantics:

* **same shard count**: exact restore; every sub-DEG is rebuilt from its
  sections, the stacked tensors are stacked again from the restored
  builders, and the attached codec is re-encoded per shard (deterministic:
  same rows -> same calibration -> same codes; a pq restore refits).
* **different shard count**: the round-robin partition (global id ``g``
  on shard ``g % S`` at row ``g // S``) is partition-specific, so graph
  topology cannot be reused: the global vector set is reassembled in
  global-id order and the sub-DEGs are *rebuilt* at the new count.
  Vectors, params and codec survive; per-shard topology and build RNG
  streams do not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .format import SnapshotFormatError, read_snapshot, write_snapshot
from .snapshot import (HOP_TO_FILE, index_sections, params_from_payload,
                       restore_into)

KIND = "sharded_deg"


def save_sharded(sharded, path) -> None:
    sections: dict = {}
    shard_payloads = []
    for i, sh in enumerate(sharded.shards):
        secs, payload = index_sections(sh)
        for sec, entries in secs.items():
            sections[f"shard{i}/{sec}"] = entries
        shard_payloads.append(payload)
    params = dataclasses.asdict(sharded.params)
    params["hop_backend"] = HOP_TO_FILE[params["hop_backend"]]
    manifest = {
        "n_shards": sharded.n_shards,
        "params": params,
        "codec": sharded.codec,
        "shards": shard_payloads,
    }
    write_snapshot(path, KIND, sections, manifest)


def load_sharded(path, n_shards: Optional[int] = None, wave_size: int = 8,
                 device="cuda"):
    """Restore a ShardedDEG onto ``device``.  ``n_shards=None`` (or the
    saved count) is the exact restore; a different count rebuilds from
    the persisted vectors (see the module docstring)."""
    from repro_torch.core.build import DEGIndex
    from repro_torch.distributed.index import ShardedDEG, build_sharded_deg

    manifest, sections = read_snapshot(path, expected_kind=KIND)
    S = int(manifest["n_shards"])
    params = params_from_payload(manifest["params"])
    codec = manifest["codec"]

    shards = []
    for i, payload in enumerate(manifest["shards"]):
        prefix = f"shard{i}/"
        secs = {sec[len(prefix):]: entries
                for sec, entries in sections.items()
                if sec.startswith(prefix)}
        if "vectors" not in secs:
            raise SnapshotFormatError(
                f"{path}: manifest names shard {i} but its sections are "
                "missing")
        sh = DEGIndex(int(payload["dim"]), params,
                      capacity=int(payload["capacity"]), device=device)
        restore_into(sh, payload, secs)
        shards.append(sh)

    if n_shards is not None and int(n_shards) != S:
        # reshard-on-restore: reassemble the global id order and rebuild
        vectors = np.zeros((sum(sh.n for sh in shards), shards[0].dim),
                           np.float32)
        for s, sh in enumerate(shards):
            vectors[s: s + S * sh.n: S] = sh.vectors[: sh.n]
        return build_sharded_deg(vectors, int(n_shards), params=params,
                                 wave_size=wave_size, codec=codec,
                                 device=device)

    sd = ShardedDEG.from_shards(shards, params)
    return sd.quantize(codec) if codec != "float32" else sd
