"""Deterministic single-attention-layer toy model for the serving loop.

The port's counterpart of ``magiattention_tpu/serving/model.py``. The engine
needs exactly three maps — hidden rows to q/k/v heads, attention output back
to a hidden row, and a hidden row to the next step's input. Float32
throughout; k/v of a token depend only on that token's input, which is what
makes chunked prefill and continuous batching exactly replayable.

Weights are drawn from ``numpy.random.default_rng(seed)`` in the same order
as the JAX model, so ``ToyModel.create(seed=s)`` holds the same numbers in
both packages; :meth:`ToyModel.from_numpy` carries a JAX model's arrays
across as they are.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


class ToyModel(nn.Module):
    """One attention layer's projections: x -> (q, k, v) -> out -> x'.

    The products stay ``torch.matmul``, as the JAX package leaves them to
    XLA. On a card, TF32 is switched off for them: it keeps about three
    decimal digits, and the engine's rows are held against the replay
    oracle in float32.
    """

    def __init__(
        self,
        wq: torch.Tensor,
        wk: torch.Tensor,
        wv: torch.Tensor,
        wo: torch.Tensor,
        n_heads: int,
        n_kv_heads: int,
        head_dim: int,
    ) -> None:
        super().__init__()
        self.wq = nn.Parameter(wq, requires_grad=False)  # (d_model, hq*d)
        self.wk = nn.Parameter(wk, requires_grad=False)  # (d_model, hk*d)
        self.wv = nn.Parameter(wv, requires_grad=False)  # (d_model, hk*d)
        self.wo = nn.Parameter(wo, requires_grad=False)  # (hq*d, d_model)
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        if wq.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def d_model(self) -> int:
        return self.wq.shape[0]

    @property
    def device(self) -> torch.device:
        return self.wq.device

    @classmethod
    def from_numpy(
        cls,
        params: dict[str, np.ndarray],
        n_heads: int,
        n_kv_heads: int,
        head_dim: int,
        device: torch.device | str | None = None,
    ) -> "ToyModel":
        """A model from ``wq/wk/wv/wo`` arrays (e.g. a JAX ToyModel's), on
        the card unless ``device`` says otherwise."""
        device = resolve_device(device)

        def w(name: str) -> torch.Tensor:
            arr = np.asarray(params[name], dtype=np.float32)
            return torch.from_numpy(arr.copy()).to(device)

        return cls(
            w("wq"), w("wk"), w("wv"), w("wo"), n_heads, n_kv_heads, head_dim
        )

    @classmethod
    def create(
        cls,
        d_model: int = 32,
        n_heads: int = 4,
        n_kv_heads: int = 2,
        head_dim: int = 16,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> "ToyModel":
        """Random weights from ``seed``, drawn as the JAX model draws them."""
        rng = np.random.default_rng(seed)
        scale = d_model ** -0.5

        def w(rows: int, cols: int) -> np.ndarray:
            return (rng.standard_normal((rows, cols)) * scale).astype(np.float32)

        params = {
            "wq": w(d_model, n_heads * head_dim),
            "wk": w(d_model, n_kv_heads * head_dim),
            "wv": w(d_model, n_kv_heads * head_dim),
            "wo": w(n_heads * head_dim, d_model),
        }
        return cls.from_numpy(params, n_heads, n_kv_heads, head_dim, device)

    def qkv(
        self, x: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(t, d_model)`` hidden rows -> q ``(t, hq, d)``, k/v ``(t, hk, d)``."""
        t = x.shape[0]
        q = (x @ self.wq).reshape(t, self.n_heads, self.head_dim)
        k = (x @ self.wk).reshape(t, self.n_kv_heads, self.head_dim)
        v = (x @ self.wv).reshape(t, self.n_kv_heads, self.head_dim)
        return q, k, v

    def project(self, attn_out: torch.Tensor) -> torch.Tensor:
        """Attention output ``(t, hq, dv)`` -> hidden rows ``(t, d_model)``."""
        t = attn_out.shape[0]
        return attn_out.reshape(t, -1) @ self.wo

    def next_input(self, hidden: torch.Tensor) -> torch.Tensor:
        """The autoregressive closure: a generated hidden row becomes the
        next step's input row (tanh keeps magnitudes bounded)."""
        return torch.tanh(hidden)

    def draft_next(self, x: torch.Tensor) -> torch.Tensor:
        """Greedy zero-context draft of the next input: the layer run as if
        ``x`` were the only token (softmax over one position makes the
        attention output just ``v``), closed with ``next_input``. No cache
        access; right whenever attention is dominated by the current token,
        which the speculative engine's accept rate measures."""
        _, _, v = self.qkv(x[None])  # (1, hk, d)
        g = self.n_heads // self.n_kv_heads
        out = v[0].repeat_interleave(g, dim=0)[None]  # (1, hq, d)
        return self.next_input(self.project(out)[0])

    def prompt(self, length: int, seed: int) -> torch.Tensor:
        """A deterministic synthetic prompt ``(length, d_model)``, drawn as
        the JAX model draws it, on the model's device."""
        rng = np.random.default_rng(seed)
        arr = rng.standard_normal((length, self.d_model)).astype(np.float32)
        return torch.from_numpy(arr).to(self.device)
