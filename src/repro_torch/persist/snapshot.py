"""Full-state snapshot/restore of one :class:`repro_torch.core.build.DEGIndex`.

The file format is the JAX package's (``persist/format.py`` holds the
envelope): a snapshot either package writes loads into the other.  What a
``deg_index`` snapshot carries (sections sized by ``n``, the live
vertices):

* ``graph``   — dense adjacency + weights rows of the live vertices;
* ``vectors`` — the float32 rows the index serves from;
* ``store_{codec}`` — every materialized compressed store: encoded rows
  plus the codec's calibration state (the sq8 per-dimension scale, the pq
  codebooks), so a restored index serves compressed searches
  bit-identically without re-encoding (and skips pq's host k-means fit);
* ``pending`` — points buffered before the ``K_{d+1}`` bootstrap exists;
* payload — ``DEGParams``, the build RNG stream state (bit-identical
  resume), ``build_stats``, the checkpoint wave counter, the cached
  medoid seed and the WAL cursor.

Two places where the port's state differs from the file's:

* ``params["hop_backend"]``: the file keeps the JAX package's names
  (``"jnp"`` / ``"pallas"``); the port's ``"composed"`` / ``"fused"`` are
  mapped when it writes and when it reads (:data:`HOP_TO_FILE`);
* ``scale`` of every store: the JAX package keeps float32 ones of shape
  ``(dim,)`` beside every codec but sq8, the port keeps None; the port
  writes the ones and drops them on read.

The restored index lives on the ``device`` given to :func:`load_index`
and is immediately mutable: the graph goes through ``GraphBuilder.load``,
whose device cache is rebuilt on the first ``device_graph()``.

Checkpoints are ordinary snapshots taken at wave boundaries, written by
``DEGIndex._checkpoint_tick`` from ``_insert_wave`` / ``refine_sweep``.
Resuming = ``load_index(ckpt)`` + ``add(points[idx.n:])`` with the same
wave size: the RNG stream and wave partitioning line up, so the resumed
build is bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .format import read_snapshot, write_snapshot

KIND = "deg_index"

#: the port's ``DEGParams.hop_backend`` -> the name the file keeps
HOP_TO_FILE = {"composed": "jnp", "fused": "pallas"}
_HOP_FROM_FILE = {v: k for k, v in HOP_TO_FILE.items()}


def index_sections(index) -> tuple[dict, dict]:
    """The (sections, payload) pair for one DEGIndex."""
    n = index.n
    sections: dict = {
        "vectors": {"data": np.asarray(index.vectors[:n], np.float32)},
    }
    if index.builder is not None:
        sections["graph"] = {
            "adjacency": np.asarray(index.builder.adjacency[:n], np.int32),
            "weights": np.asarray(index.builder.weights[:n], np.float32),
        }
    if index._pending:
        sections["pending"] = {"data": np.stack(index._pending).astype(
            np.float32)}
    for codec, store in index._stores.items():
        sec = {
            "data": store.data[:n].cpu().numpy(),
            "scale": (store.scale.cpu().numpy().astype(np.float32)
                      if store.scale is not None
                      else np.ones((index.dim,), np.float32)),
        }
        if store.codebooks is not None:      # pq: shared k-means codebooks
            sec["codebooks"] = store.codebooks.cpu().numpy().astype(
                np.float32)
        sections[f"store_{codec}"] = sec
    params = dataclasses.asdict(index.params)
    params["hop_backend"] = HOP_TO_FILE[params["hop_backend"]]
    payload = {
        "dim": int(index.dim),
        "capacity": int(index.capacity),
        "n": int(n),
        "params": params,
        "rng_state": index._rng.bit_generator.state,
        "build_stats": {k: (int(v) if isinstance(v, (int, np.integer))
                            else float(v))
                        for k, v in index.build_stats.items()},
        "wave_counter": int(index._wave_counter),
        "medoid": None if index._medoid is None else int(index._medoid),
        "stores": sorted(index._stores),
        "has_builder": index.builder is not None,
        # WAL cursor: ops with seq >= wal_seq postdate this snapshot and
        # are re-applied by persist.wal.replay_wal on recovery
        "wal_seq": int(index._wal_seq),
    }
    return sections, payload


def params_from_payload(params: dict):
    """``DEGParams`` from a payload's ``params`` dict (either package's
    hop names)."""
    from repro_torch.core.build import DEGParams

    p = dict(params)
    p["hop_backend"] = _HOP_FROM_FILE.get(p["hop_backend"], p["hop_backend"])
    return DEGParams(**p)


def restore_into(index, payload: dict, sections: dict) -> None:
    """Rebuild ``index``'s state (graph, vectors, stores, counters) from a
    verified (payload, sections) pair.  ``index`` must be freshly
    constructed with the payload's dim/params/capacity."""
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.quant.store import VectorStore

    dev = index.device
    n = int(payload["n"])
    vec = sections["vectors"]["data"]
    if n:
        index.vectors[:n] = vec
        index._put_rows(vec, 0)
    if payload["has_builder"]:
        b = GraphBuilder(index.capacity, index.params.degree, device=dev)
        g = sections["graph"]
        b.load(g["adjacency"], g["weights"], n)
        index.builder = b
    index._pending = ([row.copy() for row in sections["pending"]["data"]]
                      if "pending" in sections else [])
    for codec in payload["stores"]:
        s = sections[f"store_{codec}"]
        # row width comes from the section, not index.dim — pq rows hold
        # m_sub code bytes, not dim elements
        data = np.zeros((index.capacity,) + s["data"].shape[1:],
                        dtype=s["data"].dtype)
        data[:n] = s["data"]
        index._stores[codec] = VectorStore(
            data=torch.tensor(data, device=dev), codec=codec,
            scale=(torch.tensor(s["scale"], device=dev) if codec == "sq8"
                   else None),
            codebooks=(torch.tensor(s["codebooks"], device=dev)
                       if "codebooks" in s else None))
    rng = np.random.default_rng()
    rng.bit_generator.state = payload["rng_state"]
    index._rng = rng
    index.build_stats = dict(payload["build_stats"])
    index._wave_counter = int(payload["wave_counter"])
    index._medoid = payload["medoid"]
    index._wal_seq = int(payload.get("wal_seq", 0))   # pre-WAL snapshots: 0


def save_index(index, path) -> None:
    """Serialize the complete index state to one versioned npz snapshot."""
    sections, payload = index_sections(index)
    write_snapshot(path, KIND, sections, payload)


def load_index(path, params: Optional[object] = None,
               capacity: Optional[int] = None, device="cuda"):
    """Restore a :class:`DEGIndex` from ``path`` onto ``device``.

    ``params`` overrides the persisted search knobs (a restored index may
    serve a different engine config); the structural fields (``degree``,
    ``metric``) must match the snapshot — a mismatched graph would be
    silently wrong, so it raises.  ``capacity`` may only grow the index.
    """
    from repro_torch.core.build import DEGIndex

    payload, sections = read_snapshot(path, expected_kind=KIND)
    saved = params_from_payload(payload["params"])
    if params is None:
        params = saved
    elif (params.degree != saved.degree or params.metric != saved.metric):
        raise ValueError(
            f"params override (degree={params.degree}, "
            f"metric={params.metric!r}) is structurally incompatible with "
            f"the snapshot (degree={saved.degree}, metric={saved.metric!r})")
    cap = int(payload["capacity"])
    if capacity is not None:
        cap = max(cap, int(capacity))
    index = DEGIndex(int(payload["dim"]), params, capacity=cap, device=device)
    restore_into(index, payload, sections)
    return index
