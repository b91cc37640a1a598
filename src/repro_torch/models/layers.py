"""The neural layers the recsys towers use, ported from
``src/repro/models/layers.py`` (``dense_init``, ``mlp_tower``,
``apply_mlp_tower``).  Parameters are float32 tensors drawn from an
explicit ``torch.Generator`` on the given device.  Norms, rotary
embeddings, attention and the gated MLPs wait for the LM slice."""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch

_LO, _HI = -2.0, 2.0                    # jax.random.truncated_normal bounds


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               device="cuda") -> torch.Tensor:
    """``scale`` (default ``1/sqrt(shape[-2])``, or ``shape[-1]`` for a
    vector) times a normal truncated to [-2, 2], by inverse-CDF sampling
    in place, so a table of gigabytes needs no second buffer."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2 * _normal_cdf(_LO) - 1, 2 * _normal_cdf(_HI) - 1,
               generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(_LO, _HI).mul_(scale)


def mlp_tower(generator: torch.Generator, sizes: list[int],
              device="cuda") -> dict:
    """Plain MLP parameter stack: sizes [in, h1, ..., out] -> ``w{i}``
    (sizes[i], sizes[i+1]) and zero biases ``b{i}``."""
    n = len(sizes) - 1
    p = {f"w{i}": dense_init(generator, (sizes[i], sizes[i + 1]),
                             device=device) for i in range(n)}
    return p | {f"b{i}": torch.zeros(sizes[i + 1], device=device)
                for i in range(n)}


def apply_mlp_tower(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                    act: Callable = torch.relu,
                    final_act: Optional[Callable] = None) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    dt = x.dtype
    for i in range(n):
        x = x @ params[f"w{i}"].to(dt) + params[f"b{i}"].to(dt)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
