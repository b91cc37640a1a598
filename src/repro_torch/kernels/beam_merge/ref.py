"""Plain PyTorch version of the beam merge: a stable argsort over the
``[beam | candidates]`` concatenation (the seed merge semantics)."""
from __future__ import annotations

import torch


def beam_merge_ref(beam_dists, beam_ids, beam_chk, beam_exc,
                   cand_dists, cand_ids, cand_chk, cand_exc):
    """(B, L) sorted beam + (B, d) candidates -> merged (B, L) 4-tuple
    (dists, ids, checked, excluded): the first L entries of the stable sort
    of the concatenation, so ties keep beam-before-candidate order."""
    L = beam_dists.shape[-1]
    all_d = torch.cat([beam_dists, cand_dists], dim=-1)
    order = torch.argsort(all_d, dim=-1, stable=True)[..., :L]

    def take(b, c):
        return torch.gather(torch.cat([b, c], dim=-1), -1, order)

    return (torch.gather(all_d, -1, order), take(beam_ids, cand_ids),
            take(beam_chk, cand_chk), take(beam_exc, cand_exc))
