"""Partial-attention merge math.

The port's copy of ``magiattention_tpu/functional/utils.py``: the
log-sum-exp identities that combine partial attention results over
disjoint key sets (the CP runtime's host and remote parts). Every function
is -inf safe: a part with no key (lse = -inf, out = 0) contributes nothing,
and a row no part covers comes out as out 0, lse -inf, never NaN.
"""

from __future__ import annotations

import torch


def safe_logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """logaddexp that returns -inf (not NaN) when both inputs are -inf."""
    both_inf = torch.isneginf(a) & torch.isneginf(b)
    m = torch.maximum(a, b)
    m_safe = torch.where(both_inf, 0.0, m)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(both_inf, float("-inf"), out)


def correct_attn_lse(lse1: torch.Tensor, lse2: torch.Tensor) -> torch.Tensor:
    """Merged lse of two partial attentions over disjoint key sets."""
    return safe_logaddexp(lse1, lse2)


def correct_attn_out_lse(
    out1: torch.Tensor,
    lse1: torch.Tensor,
    out2: torch.Tensor,
    lse2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial attention results over disjoint key sets.

    Args:
        out1/out2: ``[s, h, dv]`` partial outputs.
        lse1/lse2: ``[s, h]`` partial lse (float32, -inf where empty).

    Returns:
        (out, lse) of the union, out in out1's dtype.
    """
    lse = correct_attn_lse(lse1, lse2)
    base = torch.where(torch.isneginf(lse), 0.0, lse)
    w1 = torch.exp(torch.where(torch.isneginf(lse1), float("-inf"), lse1 - base))
    w2 = torch.exp(torch.where(torch.isneginf(lse2), float("-inf"), lse2 - base))
    out = out1.float() * w1[..., None] + out2.float() * w2[..., None]
    return out.to(out1.dtype), lse


def lse_weighted_reduce(
    outs: torch.Tensor,
    lses: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge P stacked partials in one shot.

    Args:
        outs: ``[P, s, h, dv]`` partial outputs.
        lses: ``[P, s, h]`` partial lses (float32, -inf where empty).

    Returns:
        (out ``[s, h, dv]`` in outs' dtype, lse ``[s, h]``).
    """
    m = lses.amax(dim=0)  # [s, h]
    all_inf = torch.isneginf(m)
    m_safe = torch.where(all_inf, 0.0, m)
    w = torch.exp(lses - m_safe[None])  # [P, s, h]; exp(-inf - c) = 0
    denom = w.sum(dim=0)
    lse = torch.where(all_inf, float("-inf"), m_safe + torch.log(denom))
    out = torch.einsum("pshd,psh->shd", outs.float(), w) / torch.where(
        all_inf, 1.0, denom
    )[..., None]
    return out.to(outs.dtype), lse
