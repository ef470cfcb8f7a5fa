"""Sequential per-request replay — the engine's oracle.

The port's counterpart of ``magiattention_tpu/serving/reference.py``. Each
request runs alone against a fresh single-sequence cache with every page
pre-assigned, using the SAME :func:`~.prefill.prefill_request` chunk
schedule, and decodes each token through
:func:`~..kernels.paged_kv.paged_attn` — the FFA forward, not the
paged-decode kernel. On a card the engine checked against this replay
therefore holds two independent kernels against each other; the engine's
rows agree with the replay within float32 tolerance (the two kernels sum in
different orders), where the TPU package, whose gather rung shares the
oracle's kernel, asserts bitwise equality.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.paged_kv import PagedKVCache, append_kv, assign_pages, paged_attn
from .engine import ServeConfig
from .model import ToyModel
from .prefill import prefill_request
from .scheduler import ServeRequest


@torch.no_grad()
def generate_reference(
    model: ToyModel, req: ServeRequest, config: ServeConfig
) -> list[np.ndarray]:
    """Generate ``req``'s tokens in isolation on the model's device;
    returns the per-step hidden rows (as the engine stores them in
    ``req.generated``)."""
    P = config.max_pages_per_seq
    cache = PagedKVCache.create(
        num_pages=P,
        page_size=config.page_size,
        n_kv_heads=model.n_kv_heads,
        head_dim=model.head_dim,
        max_seqs=1,
        max_pages_per_seq=P,
        dtype=torch.float32,
        device=model.device,
    )
    cache = assign_pages(cache, 0, np.arange(P, dtype=np.int32))

    cache, last_hidden = prefill_request(
        model, cache, 0, req.prompt.to(model.device), config.prefill_chunk,
        config.softmax_scale,
    )
    length = req.prompt_len
    x = model.next_input(last_hidden)

    outs: list[np.ndarray] = []
    for _ in range(req.max_new_tokens):
        q, k, v = model.qkv(x[None])
        cache = append_kv(cache, 0, k, v)
        length += 1
        out, _ = paged_attn(
            q, cache, 0,
            q_start=length - 1,
            max_pages=P,
            softmax_scale=config.softmax_scale,
        )
        hidden = model.project(out)[0]
        outs.append(hidden.cpu().numpy())
        x = model.next_input(hidden)
    return outs


def run_reference(
    model: ToyModel, requests: list[ServeRequest], config: ServeConfig
) -> dict[int, list[np.ndarray]]:
    """Replay every request sequentially; keyed by ``req_id``."""
    return {
        req.req_id: generate_reference(model, req, config)
        for req in requests
    }
