"""The four assigned recsys architectures (exact public configs), ported
from ``src/repro/configs/recsys_archs.py``."""
from __future__ import annotations

from repro_torch.models.recsys import (CRITEO_KAGGLE_VOCABS, CRITEO_TB_VOCABS,
                                       RecsysConfig)

from .base import ArchSpec, RECSYS_SHAPES


def _reduced_recsys(kind: str):
    if kind == "din":
        return RecsysConfig(
            name=f"{kind}-reduced", kind="din", n_dense=0, n_sparse=3,
            embed_dim=8, vocab_sizes=(50, 20, 30), mlp=(32, 16),
            attn_mlp=(16, 8), seq_len=10, item_field=0)
    if kind == "deepfm":
        return RecsysConfig(
            name=f"{kind}-reduced", kind="deepfm", n_dense=0, n_sparse=6,
            embed_dim=6, vocab_sizes=(40,) * 6, mlp=(32, 16))
    n_cross = 2 if kind == "dcn-v2" else 0
    bot = (16, 8) if kind == "dlrm" else ()
    return RecsysConfig(
        name=f"{kind}-reduced", kind=kind, n_dense=4, n_sparse=5,
        embed_dim=8, vocab_sizes=(30,) * 5, mlp=(32, 16), bot_mlp=bot,
        n_cross=n_cross)


DCN_V2 = ArchSpec(
    name="dcn-v2", family="recsys",
    model=RecsysConfig(
        name="dcn-v2", kind="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_sizes=CRITEO_KAGGLE_VOCABS, mlp=(1024, 1024, 512), n_cross=3),
    shapes=RECSYS_SHAPES,
    reduced=lambda: _reduced_recsys("dcn-v2"),
    notes="arXiv:2008.13535 — 3 cross layers, Criteo-Kaggle vocabularies")

DEEPFM = ArchSpec(
    name="deepfm", family="recsys",
    model=RecsysConfig(
        name="deepfm", kind="deepfm", n_dense=0, n_sparse=39, embed_dim=10,
        # 26 categorical + 13 bucketized-dense fields (64 buckets each)
        vocab_sizes=CRITEO_KAGGLE_VOCABS + (64,) * 13,
        mlp=(400, 400, 400)),
    shapes=RECSYS_SHAPES,
    reduced=lambda: _reduced_recsys("deepfm"),
    notes="arXiv:1703.04247 — FM + deep tower, 39 fields")

DIN = ArchSpec(
    name="din", family="recsys",
    model=RecsysConfig(
        name="din", kind="din", n_dense=0, n_sparse=3, embed_dim=18,
        # fields: item (63001), category (801), user segment (192403)
        vocab_sizes=(63001, 801, 192403), mlp=(200, 80),
        attn_mlp=(80, 40), seq_len=100, item_field=0),
    shapes=RECSYS_SHAPES,
    reduced=lambda: _reduced_recsys("din"),
    notes="arXiv:1706.06978 — target attention over 100-item history "
          "(Amazon-Electronics-scale vocabularies)")

DLRM_MLPERF = ArchSpec(
    name="dlrm-mlperf", family="recsys",
    model=RecsysConfig(
        name="dlrm-mlperf", kind="dlrm", n_dense=13, n_sparse=26,
        embed_dim=128, vocab_sizes=CRITEO_TB_VOCABS,
        bot_mlp=(512, 256, 128), mlp=(1024, 1024, 512, 256, 1)),
    shapes=RECSYS_SHAPES,
    reduced=lambda: _reduced_recsys("dlrm"),
    notes="arXiv:1906.00091 + MLPerf config — Criteo-1TB vocabularies "
          f"({sum(CRITEO_TB_VOCABS):,} rows x 128)")
