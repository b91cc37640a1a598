"""Three-term roofline model for one NVIDIA H100 SXM, ported from
``src/repro/analysis/roofline.py`` with the card's figures in place of the
TPU's.

    T_comp = FLOPs/device   / PEAK_FLOPS
    T_mem  = bytes/device   / HBM_BW
    T_coll = collective_bytes/device / LINK_BW

MODEL_FLOPS (the analytic 6·N·D / 6·N_active·D useful-work count) is
reported next to a measured or compiled count so waste is visible.  The
model-flops functions read only attributes of the config they are given,
so any config object with those attributes will do.

The constants are NVIDIA's published peaks of the H100 SXM at its 700 W
limit (data sheet, dense rates), not measurements; ``chip_smoke.py``'s
kernel bounds take them from here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# H100 SXM, one card: vendor figures, not measurements
PEAK_FLOPS = 67e12           # float32 outside the tensor cores: what the
                             # port's kernels and its TF32-off towers use
PEAK_FLOPS_BF16 = 989.4e12   # dense bfloat16 on the tensor cores: what the
                             # LMs' bfloat16 products can reach
HBM_BW = 3.35e12             # HBM3, bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s in each direction
# the names chip_smoke.py's kernel bounds read
HBM_BYTES_PER_S = HBM_BW
FP32_OPS_PER_S = PEAK_FLOPS


@dataclasses.dataclass
class Roofline:
    t_comp: float
    t_mem: float
    t_coll: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float = 0.0
    devices: int = 1

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: perfectly-overlapped terms."""
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / HLO FLOPs (global): remat/dispatch waste detector."""
        total = self.flops * self.devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU at the roofline: useful flops / (peak x step_time)."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.devices * PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "t_comp_s": self.t_comp, "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll, "bottleneck": self.bottleneck,
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
            "step_time_s": self.step_time,
        }


def from_costs(flops: float, hbm_bytes: float, collective_bytes: float,
               *, model_flops: float = 0.0, devices: int = 1) -> Roofline:
    return Roofline(
        t_comp=flops / PEAK_FLOPS,
        t_mem=hbm_bytes / HBM_BW,
        t_coll=collective_bytes / LINK_BW,
        flops=flops, hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops, devices=devices)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS per cell family (useful work, not compiled work)
# ---------------------------------------------------------------------------
def _tower_flops(sizes) -> float:
    return float(sum(2.0 * a * b for a, b in zip(sizes[:-1], sizes[1:])))


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N_active·tokens (+ attention) for train, 2·N_active·tokens for
    inference; attention term uses per-layer effective context."""
    n_active = cfg.active_param_count
    L, Hq, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    glob = cfg.is_global_layer()

    def attn(tok_s, ctx, causal):
        tot = 0.0
        for i in range(L):
            eff = ctx if glob[i] else min(ctx, cfg.sliding_window or ctx)
            f = 4.0 * batch * tok_s * eff * Hq * Dh
            tot += f / 2 if causal else f
        return tot

    if kind == "train":
        return 6.0 * n_active * batch * seq + 3.0 * attn(seq, seq, True)
    if kind == "prefill":
        return 2.0 * n_active * batch * seq + attn(seq, seq, True)
    # decode/long_decode: one token against a seq-length cache
    return 2.0 * n_active * batch + attn(1, seq, False)


def egnn_model_flops(cfg, n_nodes: int, n_edges: int, train: bool = True,
                     batch: int = 1) -> float:
    h = cfg.d_hidden
    per_layer = (
        n_edges * _tower_flops([2 * h + 1 + cfg.d_edge, h, h])      # phi_e
        + n_edges * _tower_flops([h, h, 1])                         # phi_x
        + n_nodes * _tower_flops([2 * h, h, h])                     # phi_h
    )
    total = (cfg.n_layers * per_layer
             + n_nodes * 2.0 * cfg.d_feat * h                       # encoder
             + n_nodes * _tower_flops([h, h, cfg.n_classes]))       # decoder
    total *= batch
    return 3.0 * total if train else total


def recsys_model_flops(cfg, kind: str, batch: int,
                       n_candidates: int = 0) -> float:
    E, F = cfg.embed_dim, cfg.n_sparse
    f = 0.0
    if cfg.kind == "dlrm":
        f += _tower_flops([cfg.n_dense, *cfg.bot_mlp])
        n_int = F + 1
        f += 2.0 * n_int * n_int * E                  # dot interactions
        f += _tower_flops([E + n_int * (n_int - 1) // 2, *cfg.mlp])
    elif cfg.kind == "dcn-v2":
        d = cfg.x0_dim
        f += cfg.n_cross * 2.0 * d * d
        f += _tower_flops([d, *cfg.mlp, 1])
    elif cfg.kind == "deepfm":
        f += 4.0 * F * E
        f += _tower_flops([cfg.x0_dim, *cfg.mlp, 1])
    elif cfg.kind == "din":
        f += cfg.seq_len * _tower_flops([4 * E, *cfg.attn_mlp, 1])
        f += _tower_flops([cfg.x0_dim, *cfg.mlp, 1])
    per_ex = f
    if kind == "retrieval":
        return batch * (per_ex + 2.0 * n_candidates * E)
    mult = 3.0 if kind == "recsys_train" else 1.0
    return mult * batch * per_ex


# ---------------------------------------------------------------------------
# structural kernel tiles: HBM bytes + flops per tile of the JAX package's
# Pallas kernels (one lane's hop, one merge), the unit the serving
# telemetry's hop and eval counters count
# ---------------------------------------------------------------------------
# dims at the production-search cell scale (the JAX package's DEG_CELLS):
# degree 30, dim 128, beam 64, k_ext 60; int8 codes for the sq8 store.
KERNEL_DIMS = {
    "gather_dist": dict(d=30, m=128),
    "gather_dist_q": dict(d=30, m=128),
    "beam_merge": dict(L=64, d=30),
    "mrng_occlusion": dict(K=60, d=30, m=128),
    "fused_hop": dict(E=4, d=30, m=128, V=2048),
}


def kernel_tile_costs(name: str, **dims) -> dict:
    """Structural per-tile costs of the named kernel.

    * ``gather_dist``     — d float32 rows + query + out;
    * ``gather_dist_q``   — d int8 code rows + f32 scale/query/out (the
      ~4x gather-traffic cut vs gather_dist);
    * ``beam_merge``      — the (L + d) bitonic partial merge over 4
      channels (dists f32, ids i32, checked/excluded bytes), in + out;
    * ``mrng_occlusion``  — K*d gathered f32 rows + query + candidate
      dists + neighbor weights in, distances + occlusion mask out; one
      distance (2m) plus the lune compare per gathered row.
    * ``fused_hop``       — one multi-expansion hop for one lane: E
      adjacency rows + the (1, V) visited table + query in, E*d gathered
      f32 vector rows (worst case: nothing filtered), compacted
      candidates + raw neighbor ids + eval count out; per gathered row
      one distance (2m) plus the E*d-lane seen/visited row compares.
    """
    if name == "gather_dist":
        d, m = dims["d"], dims["m"]
        return {"hbm_bytes": (d * m + m + d) * 4, "flops": 2.0 * d * m}
    if name == "gather_dist_q":
        d, m = dims["d"], dims["m"]
        return {"hbm_bytes": d * m + (m + m + d) * 4,
                "flops": 3.0 * d * m}
    if name == "beam_merge":
        L, d = dims["L"], dims["d"]
        n = L + d
        passes = max(1, int(np.ceil(np.log2(max(n, 2)))))
        return {"hbm_bytes": 2 * n * (4 + 4 + 1 + 1),
                "flops": float(n * passes)}
    if name == "mrng_occlusion":
        K, d, m = dims["K"], dims["d"], dims["m"]
        # f32: gathered rows + query + cand dists + weights + both outputs;
        # plus the K*d int32 neighbor-id array driving the gather
        return {"hbm_bytes": (K * d * m + m + K + 3 * K * d) * 4 + K * d * 4,
                "flops": K * d * (2.0 * m + 2.0)}
    if name == "fused_hop":
        E, d, m, V = dims["E"], dims["d"], dims["m"], dims["V"]
        # in: E i32 adjacency rows, (1, V) i32 visited table, f32 query;
        # E*d f32 vector rows DMA'd (worst case: visited filters nothing);
        # out: compacted ids+dists, raw neighbor ids, eval count.  Per
        # gathered row: one distance (2m) + the seen/visited row compares
        # (E*d + V lanes) + the keep/compaction select.
        return {"hbm_bytes": ((E * d + V + E * d) * 4 + m * 4
                              + E * d * m * 4
                              + (E * d * 2 + E * d + 1) * 4),
                "flops": E * d * (2.0 * m + E * d + V + 2.0)}
    raise ValueError(f"unknown kernel {name!r}; have {sorted(KERNEL_DIMS)}")


def kernel_roofline(name: str, **dims) -> Roofline:
    """Single-tile roofline of a kernel (no collectives)."""
    c = kernel_tile_costs(name, **(dims or KERNEL_DIMS[name]))
    return from_costs(c["flops"], c["hbm_bytes"], 0.0,
                      model_flops=c["flops"])


def attribute_kernel_time(total_s: float, tile_counts: dict) -> dict:
    """Split a *measured* wall-time total across kernels in proportion to
    their structural cost: weight(k) = tiles_k x the single-tile roofline
    step time (max of the compute/memory terms).

    This is the bridge between the serving telemetry (obs/ histograms
    measure how long flushes took, but not which kernel took it) and the
    structural model (which knows each kernel's relative expense but not
    the wall clock): tile counts come from the engine's hop/eval
    counters, the split from the model.  Returns
    ``{kernel: {"tiles", "weight_s", "seconds", "fraction"}}``; fractions
    sum to 1 when any weight is nonzero.
    """
    weights = {}
    for name, tiles in tile_counts.items():
        r = kernel_roofline(name, **KERNEL_DIMS[name])
        weights[name] = float(tiles) * r.step_time
    denom = sum(weights.values())
    out = {}
    for name, tiles in tile_counts.items():
        frac = weights[name] / denom if denom > 0 else 0.0
        out[name] = {"tiles": float(tiles), "weight_s": weights[name],
                     "seconds": frac * total_s, "fraction": frac}
    return out


def deg_model_flops(meta: dict, avg_hops: float) -> float:
    """Per-query useful work: hops x (d neighbor distances) + seed + merge.
    One distance = 2m flops (paper's SIMD L2 analogue)."""
    d, m, B = meta["degree"], meta["dim"], meta["batch"]
    per_hop = d * 2.0 * m
    return B * meta["n_shards"] * avg_hops * per_hop


def model_flops_for(meta: dict, kind: str, cell_dims: dict,
                    avg_hops: float = 48.0) -> float:
    fam = meta.get("family")
    cfg = meta.get("cfg")
    if fam == "lm":
        if kind == "train":
            return lm_model_flops(cfg, "train", cell_dims["global_batch"],
                                  cell_dims["seq_len"])
        if kind == "prefill":
            return lm_model_flops(cfg, "prefill", cell_dims["global_batch"],
                                  cell_dims["seq_len"])
        return lm_model_flops(cfg, "decode", cell_dims["global_batch"],
                              cell_dims["seq_len"])
    if fam == "gnn":
        if kind == "molecule":
            return egnn_model_flops(cfg, cell_dims["n_nodes"],
                                    cell_dims["n_edges"], True,
                                    cell_dims["batch"])
        return egnn_model_flops(cfg, meta["n_nodes"], meta["n_edges"], True)
    if fam == "recsys":
        return recsys_model_flops(cfg, kind, cell_dims["batch"],
                                  cell_dims.get("n_candidates", 0))
    if fam == "deg":
        return deg_model_flops(meta, meta.get("est_hops", avg_hops))
    return 0.0


def history_grad_costs(B: int, F: int, E: int, V: int, n_valid: int,
                       n_rows: int, weighted: bool = True) -> dict:
    """The least bytes and flops of DIN's whole history gradient, the
    transpose of one lookup ``hist = table[ids]`` (B, F, E) pooled by
    ``sum_f w * hist``: ids (B, F) int32 read; the ``n_valid`` valid
    entries' weights and their rows of the cotangent G (B, F, E) float32
    read (an invalid slot's G and weight enter no gradient); dL/dout g
    (B, E) read; each of the ``n_rows`` distinct rows a valid id names
    read once (for ``grad_w``); ``grad_w`` (B, F) and the dense
    ``grad_table`` (V, E) float32 written once.  Per valid id, an E-long
    dot product (``grad_w``), an E-long scaled add (``w * g``) and E adds
    (G and the row's sum)."""
    n_bytes = (B * F * 4 + n_valid * 4 * weighted + n_valid * E * 4
               + B * E * 4 + n_rows * E * 4 + B * F * 4 + V * E * 4)
    return {"hbm_bytes": float(n_bytes), "flops": 5.0 * E * n_valid}


def bwd_order_costs(B: int, F: int, E: int, n_valid: int, n_rows: int,
                    weighted: bool = True) -> dict:
    """``bag_bwd_order``'s least bytes and flops: ids (B, F) int32 and the
    valid entries' weights read, their keys, positions (int32) and weights
    written once in row order; for ``grad_w`` g (B, E) and the ``n_rows``
    distinct rows read and ``grad_w`` (B, F) written.  Per valid id, an
    E-long dot product."""
    n_bytes = (B * F * 4 + n_valid * 4 * weighted
               + n_valid * 4 * (2 + weighted) + B * E * 4 + n_rows * E * 4
               + B * F * 4)
    return {"hbm_bytes": float(n_bytes), "flops": 2.0 * E * n_valid}


def table_grad_costs(B: int, F: int, E: int, V: int, n_valid: int,
                     weighted: bool = True) -> dict:
    """``bag_lookup_bwd``'s least bytes and flops from the sorted order:
    the valid entries' keys, positions and weights read, their rows of G
    (B, F, E) and g (B, E) read, the dense ``grad_table`` (V, E) float32
    written once.  Per valid id, an E-long scaled add and E adds."""
    n_bytes = (n_valid * 4 * (2 + weighted) + n_valid * E * 4 + B * E * 4
               + V * E * 4)
    return {"hbm_bytes": float(n_bytes), "flops": 3.0 * E * n_valid}
