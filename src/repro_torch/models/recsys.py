"""RecSys architectures: DLRM (MLPerf), DCN-v2, DeepFM, DIN, ported from
``src/repro/models/recsys.py``.

Common skeleton: huge sparse embedding tables (stacked per-field into ONE
(V_total, E) table with static row offsets) -> a feature-interaction op
(dot / cross / FM / target-attention) -> a small MLP tower -> 1 logit.

The model is a :class:`RecsysModel` whose parameter names are the JAX
parameter dict's leaves (``table``, ``top_mlp.w0``, ``cross_w``, ...);
``RecsysModel.params()`` gives them as the JAX package's nested dict (the
same tensors), which is what the optimizers and the checkpoints of
``repro_torch.train`` walk.  The forward follows the JAX forward op for op,
except that ``user_embedding``'s pooled means go through
:func:`embedding_bag_fixed`, whose sum is the ``bag_lookup`` kernel on a
card, and DIN's history through ``embedding_bag.history_lookup``: its rows
(padded slots 0) and its attention-pooled interest, the ``bag_lookup``
kernel, whose table gradient from both is one ``bag_lookup_bwd`` launch
after one ``bag_bwd_order`` launch.  Every other lookup is a plain gather
(:func:`default_lookup`) with torch's embedding backward, as the JAX
package takes it with ``jnp.take`` outside any Pallas kernel.

``forward``, ``loss_fn`` and ``user_embedding`` take a ``lookup_fn``, as
the JAX functions do: an object that gathers rows (``lookup_fn(table,
ids)``), sums weighted bags (``lookup_fn.bag(table, ids, weights)``) and
takes DIN's history (``lookup_fn.history(table, ids)``) of the stacked
table, such as the row-sharded lookup of
``distributed.collectives.make_sharded_lookup``.  None takes
:func:`default_lookup`, the ``bag_lookup`` bag and ``history_lookup``.

Serving (``forward``, ``user_embedding``, ``serve_retrieval``) runs under
``torch.inference_mode()`` on frozen parameters (``model.requires_grad_()``
unfreezes them for a caller of its own).  Training goes through
:func:`loss_fn`, which runs the same forward body with autograd on, over a
model or over its ``params()`` dict.  Matrix products run in full float32:
TF32 must stay off (``torch.backends.cuda.matmul.allow_tf32``, False by
default).

Ids outside a field's vocabulary are an error, as torch indexing makes
them (an ``IndexError`` on the CPU, a device assert on a card), where
``jnp.take`` returns NaN rows.  Invalid history ids (< 0) are masked, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.embedding_bag import (embedding_bag_fixed,
                                              history_lookup,
                                              stack_vocab_offsets)
from repro_torch.models.layers import (ParamTree, abs_mlp_tower, abs_p,
                                      apply_mlp_tower, dense_init, mlp_tower)

INVALID = -1

# Criteo-Kaggle categorical cardinalities (widely published)
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
# Criteo-Terabyte cardinalities used by MLPerf DLRM (day 0-23 counts)
CRITEO_TB_VOCABS = (
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457, 11316796,
    40094537, 452104, 12606, 104, 35)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # 'dlrm' | 'dcn-v2' | 'deepfm' | 'din'
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: tuple
    mlp: tuple                      # top tower hidden sizes
    bot_mlp: tuple = ()             # dlrm bottom tower
    n_cross: int = 0                # dcn-v2
    attn_mlp: tuple = ()            # din
    seq_len: int = 0                # din history length
    item_field: int = 0             # din: which field is the target item
    dtype: torch.dtype = torch.float32
    # stacked-table row padding: round total_rows up to a multiple.
    # Padded rows are never addressed by real ids.
    table_pad_to: int = 1

    def __post_init__(self):
        if len(self.vocab_sizes) != self.n_sparse:
            raise ValueError(f"{len(self.vocab_sizes)} vocabularies for "
                             f"{self.n_sparse} sparse fields")

    @property
    def total_rows(self) -> int:
        n = int(sum(self.vocab_sizes))
        p = max(self.table_pad_to, 1)
        return -(-n // p) * p

    @property
    def x0_dim(self) -> int:
        """Input width of the interaction stage."""
        if self.kind == "dlrm":
            return self.embed_dim          # bottom-mlp output
        if self.kind == "dcn-v2":
            return self.n_dense + self.n_sparse * self.embed_dim
        if self.kind == "deepfm":
            return self.n_sparse * self.embed_dim
        if self.kind == "din":
            # target item + attention-pooled history + profile fields
            return (self.n_sparse + 1) * self.embed_dim
        raise ValueError(self.kind)


class RecsysModel(ParamTree):
    """The parameters of one recsys model under the JAX dict's names:
    tensors as frozen parameters, towers as ``nn.ParameterDict``s."""

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, batch)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def abstract_params(cfg: RecsysConfig) -> dict:
    """The parameter tree's shapes as ``meta`` tensors."""
    E = cfg.embed_dim
    p: dict = {"table": abs_p(cfg.total_rows, E)}
    if cfg.kind == "dlrm":
        p["bot_mlp"] = abs_mlp_tower([cfg.n_dense, *cfg.bot_mlp])
        n_int = cfg.n_sparse + 1
        top_in = E + n_int * (n_int - 1) // 2
        p["top_mlp"] = abs_mlp_tower([top_in, *cfg.mlp])
    elif cfg.kind == "dcn-v2":
        d = cfg.x0_dim
        p["cross_w"] = abs_p(cfg.n_cross, d, d)
        p["cross_b"] = abs_p(cfg.n_cross, d)
        p["top_mlp"] = abs_mlp_tower([d, *cfg.mlp, 1])
    elif cfg.kind == "deepfm":
        p["fm_w"] = abs_p(cfg.total_rows)      # first-order weights
        p["fm_b"] = abs_p()
        p["top_mlp"] = abs_mlp_tower([cfg.x0_dim, *cfg.mlp, 1])
    elif cfg.kind == "din":
        p["attn_mlp"] = abs_mlp_tower([4 * E, *cfg.attn_mlp, 1])
        p["top_mlp"] = abs_mlp_tower([cfg.x0_dim, *cfg.mlp, 1])
    return p


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device="cuda") -> RecsysModel:
    """Random parameters drawn from ``generator`` (on ``device``), in the
    JAX package's shapes and scales: the table at 0.01 times a truncated
    normal, towers at ``1/sqrt(fan_in)``, zero biases; frozen."""
    E = cfg.embed_dim
    g, dev = generator, device
    p: dict = {"table": dense_init(g, (cfg.total_rows, E), scale=0.01,
                                   device=dev)}
    if cfg.kind == "dlrm":
        p["bot_mlp"] = mlp_tower(g, [cfg.n_dense, *cfg.bot_mlp], device=dev)
        n_int = cfg.n_sparse + 1
        top_in = E + n_int * (n_int - 1) // 2
        p["top_mlp"] = mlp_tower(g, [top_in, *cfg.mlp], device=dev)
    elif cfg.kind == "dcn-v2":
        d = cfg.x0_dim
        p["cross_w"] = dense_init(g, (cfg.n_cross, d, d), scale=0.01,
                                  device=dev)
        p["cross_b"] = torch.zeros((cfg.n_cross, d), device=dev)
        p["top_mlp"] = mlp_tower(g, [d, *cfg.mlp, 1], device=dev)
    elif cfg.kind == "deepfm":
        p["fm_w"] = dense_init(g, (cfg.total_rows,), scale=0.01, device=dev)
        p["fm_b"] = torch.zeros((), device=dev)
        p["top_mlp"] = mlp_tower(g, [cfg.x0_dim, *cfg.mlp, 1], device=dev)
    elif cfg.kind == "din":
        p["attn_mlp"] = mlp_tower(g, [4 * E, *cfg.attn_mlp, 1], device=dev)
        p["top_mlp"] = mlp_tower(g, [cfg.x0_dim, *cfg.mlp, 1], device=dev)
    else:
        raise ValueError(cfg.kind)
    return RecsysModel(cfg, p)


def as_tensors(batch: dict, device="cuda") -> dict:
    """A batch of numpy arrays (``data/recsys.py``) as tensors on
    ``device``, dtypes kept."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# lookup plumbing
# --------------------------------------------------------------------------
def default_lookup(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Plain gather: flat_ids (...,) global row ids -> (..., E), or (...,)
    from a vector (DeepFM's first-order weights).

    ``F.embedding`` and not ``table[ids]``: the two gather alike, but the
    backward of advanced indexing sums each row's duplicates on one warp,
    which took 1.15 s of a 1.19 s DIN train step at the train_batch cell
    (NVIDIA H100 80GB HBM3, 700.00 W) when DIN's history was gathered here
    too, its Zipf head and its -1 padding (clamped to row 0) naming row 0
    some 4 million times; the embedding backward sorts the ids and sums a
    row's duplicates in parallel pieces, in a fixed order."""
    ids = flat_ids.to(torch.int64)
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def check_rows(ids: torch.Tensor, n_rows: int) -> None:
    """Raise ``IndexError`` if an id is >= ``n_rows`` (one device-to-host
    read of the largest id)."""
    if ids.numel() and int(ids.max()) >= n_rows:
        raise IndexError(f"row id {int(ids.max())} outside a table of "
                         f"{n_rows} rows")


def global_ids(cfg: RecsysConfig, sparse: torch.Tensor) -> torch.Tensor:
    """Per-field ids (B, F) -> global stacked-table rows (B, F)."""
    _, offsets = stack_vocab_offsets(cfg.vocab_sizes)
    return sparse + offsets.to(sparse.device)[None, :]


def history_ids(cfg: RecsysConfig, hist: torch.Tensor) -> torch.Tensor:
    """DIN's history (B, S) of item-field ids, -1 padded -> global rows,
    with every padded slot left at -1 (``hist + offset`` would turn it into
    a row of the field before the item field)."""
    _, offsets = stack_vocab_offsets(cfg.vocab_sizes)
    off = int(offsets[cfg.item_field])
    return torch.where(hist >= 0, hist + off, INVALID).to(torch.int32)


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------
def _dlrm_interact(emb: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """emb (B, F, E), bot (B, E) -> (B, E + F+1 choose 2) dot interactions."""
    z = torch.cat([bot[:, None, :], emb], dim=1)              # (B, F+1, E)
    zz = torch.bmm(z, z.transpose(1, 2))
    n = z.shape[1]
    iu = torch.triu_indices(n, n, offset=1, device=z.device)
    flat = zz[:, iu[0], iu[1]]                                # (B, n(n-1)/2)
    return torch.cat([bot, flat], dim=1)


def _params_cfg(model_or_params, cfg: Optional[RecsysConfig]):
    if isinstance(model_or_params, RecsysModel):
        return model_or_params.params(), model_or_params.cfg
    if cfg is None:
        raise ValueError("a parameter dict needs its RecsysConfig")
    return model_or_params, cfg


def _gather(lookup_fn):
    return default_lookup if lookup_fn is None else lookup_fn


def _bag(lookup_fn, table, ids, weights=None, combiner="sum"):
    return embedding_bag_fixed(
        table, ids, weights, combiner,
        bag_fn=None if lookup_fn is None else lookup_fn.bag)


def _forward(p: dict, batch: dict, cfg: RecsysConfig,
             lookup_fn=None) -> torch.Tensor:
    """The forward over a parameter dict, with autograd as the caller has
    it; logits (B,) float32."""
    dt = cfg.dtype
    if cfg.kind == "din":
        return _din_forward(p, batch, cfg, lookup_fn)
    gids = global_ids(cfg, batch["sparse"])
    emb = _gather(lookup_fn)(p["table"], gids).to(dt)         # (B, F, E)
    if cfg.kind == "dlrm":
        dense = torch.log1p(torch.clamp_min(batch["dense"].to(dt), 0.0))
        bot = apply_mlp_tower(p["bot_mlp"], dense, act=torch.relu,
                              final_act=torch.relu)
        x = _dlrm_interact(emb, bot)
        out = apply_mlp_tower(p["top_mlp"], x, act=torch.relu)
        return out[:, 0].to(torch.float32)
    if cfg.kind == "dcn-v2":
        dense = torch.log1p(torch.clamp_min(batch["dense"].to(dt), 0.0))
        x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=1)
        x = x0
        for i in range(cfg.n_cross):
            w = p["cross_w"][i].to(dt)
            b = p["cross_b"][i].to(dt)
            x = x0 * (x @ w + b) + x                          # DCN-v2 cross
        out = apply_mlp_tower(p["top_mlp"], x, act=torch.relu)
        return out[:, 0].to(torch.float32)
    if cfg.kind == "deepfm":
        # FM second order: 0.5 * ((sum v)^2 - sum v^2), summed over E
        s = torch.sum(emb, dim=1)
        s2 = torch.sum(emb * emb, dim=1)
        fm2 = 0.5 * torch.sum(s * s - s2, dim=1)
        fm1 = torch.sum(default_lookup(p["fm_w"], gids), dim=1)
        deep = apply_mlp_tower(p["top_mlp"], emb.reshape(emb.shape[0], -1),
                               act=torch.relu)[:, 0]
        return (fm1 + fm2 + deep + p["fm_b"]).to(torch.float32)
    raise ValueError(cfg.kind)


def _din_forward(p: dict, batch: dict, cfg: RecsysConfig,
                 lookup_fn=None) -> torch.Tensor:
    dt = cfg.dtype
    gids = global_ids(cfg, batch["sparse"])
    emb = _gather(lookup_fn)(p["table"], gids).to(dt)         # (B, F, E)
    target = emb[:, cfg.item_field]                           # (B, E)
    hist_gids = history_ids(cfg, batch["hist"])               # (B, S)
    valid = (hist_gids >= 0)[..., None]
    # the rows with padded slots 0 (JAX's hist * valid) and the bag over
    # the same ids, sum_s w[b, s] * table[hist_gids[b, s]]: the bag_lookup
    # kernel, and for the table's whole gradient from both one
    # bag_bwd_order and one bag_lookup_bwd launch, as JAX transposes its
    # one lookup
    hist, bag = (history_lookup if lookup_fn is None
                 else lookup_fn.history)(p["table"], hist_gids)
    hist = hist.to(dt)
    t = target[:, None, :].expand_as(hist)
    af = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = apply_mlp_tower(p["attn_mlp"], af, act=torch.sigmoid)
    scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=1)                          # (B, S, 1)
    interest = bag(w[..., 0]).to(dt)
    x = torch.cat([emb.reshape(emb.shape[0], -1), interest], dim=1)
    out = apply_mlp_tower(p["top_mlp"], x, act=torch.relu)
    return out[:, 0].to(torch.float32)


@torch.inference_mode()
def forward(model_or_params, batch: dict,
            cfg: Optional[RecsysConfig] = None, *,
            lookup_fn=None) -> torch.Tensor:
    """Serving: logits (B,) float32, under ``torch.inference_mode()``, of
    a ``RecsysModel`` or of a parameter dict with its ``cfg``."""
    p, cfg = _params_cfg(model_or_params, cfg)
    return _forward(p, batch, cfg, lookup_fn)


def loss_fn(model_or_params, batch: dict,
            cfg: Optional[RecsysConfig] = None, *, lookup_fn=None):
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    with gradients to every parameter that takes one: over a
    ``RecsysModel``, or over a parameter dict with its ``cfg`` (what
    ``train.steps.make_train_step`` hands it)."""
    p, cfg = _params_cfg(model_or_params, cfg)
    logits = _forward(p, batch, cfg, lookup_fn)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"bce": loss}


# --------------------------------------------------------------------------
# retrieval serving
# --------------------------------------------------------------------------
@torch.inference_mode()
def user_embedding(model_or_params, batch: dict,
                   cfg: Optional[RecsysConfig] = None, *,
                   lookup_fn=None) -> torch.Tensor:
    """A query-side vector in item-embedding space: DIN's masked mean over
    its history, otherwise the mean over the sparse fields.

    Raises ``IndexError`` on a row id at or past the stacked table's end,
    as :func:`forward` does (the bag would clip it to the last row; the
    JAX package's ``jnp.take`` gives NaN).  DIN's -1 history padding stays
    valid.  The check costs one device-to-host read per call."""
    p, cfg = _params_cfg(model_or_params, cfg)
    if cfg.kind == "din":
        ids = history_ids(cfg, batch["hist"])
    else:
        ids = global_ids(cfg, batch["sparse"]).to(torch.int32)
    check_rows(ids, p["table"].shape[0])
    pooled = _bag(lookup_fn, p["table"], ids, combiner="mean")
    return pooled.to(torch.float32)


@torch.inference_mode()
def serve_retrieval(model: RecsysModel, batch: dict,
                    candidates: torch.Tensor, k: int = 100):
    """Score ``candidates`` (N, E) by inner product with each query's user
    embedding; exact top-k: (scores (B, k) descending, ids (B, k) int32)."""
    u = user_embedding(model, batch)                          # (B, E)
    scores = u @ candidates.T.to(u.dtype)                     # (B, N)
    top, ids = torch.topk(scores, k, dim=1)
    return top, ids.to(torch.int32)


def item_vectors(model: RecsysModel, field: int,
                 n_items: Optional[int] = None) -> torch.Tensor:
    """Rows of one field's embedding table = the candidate corpus (a view
    of the table)."""
    cfg = model.cfg
    _, offsets = stack_vocab_offsets(cfg.vocab_sizes)
    start = int(offsets[field])
    n = n_items or int(cfg.vocab_sizes[field])
    # jax.lax.dynamic_slice_in_dim clamps the start so the slice fits
    start = max(0, min(start, model.table.shape[0] - n))
    return model.table[start : start + n]
