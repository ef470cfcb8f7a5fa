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

The one-token-per-tick replay is also the oracle of the speculative engine:
a verify row attends its own causal prefix, so a row whose draft inputs
were right gives the sequential output, and rollback only discards rows the
oracle never produced. With ``config.kv_dtype == 'int8'`` the replay's
cache is int8 too: quantized append is a function of a page's append
history (scales only grow, reset on release), so the int8 engine tracks
the int8 replay, and int8 against float32 is the quantization error.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.paged_kv import PagedKVCache, append_kv, assign_pages, paged_attn
from .engine import DraftFn, ServeConfig
from .model import ToyModel
from .prefill import prefill_request
from .scheduler import ServeRequest


@torch.no_grad()
def generate_reference(
    model: ToyModel,
    req: ServeRequest,
    config: ServeConfig,
    forced: list[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Generate ``req``'s tokens in isolation on the model's device;
    returns the per-step hidden rows (as the engine stores them in
    ``req.generated``).

    ``forced`` (another run's rows, e.g. the engine's) feeds step i + 1 the
    input ``next_input(forced[i])`` in place of the replay's own: the
    replay then appends the same k/v rows as that run, so on an int8 cache
    both hold the same codes and differ only in attention. Free-running,
    a last-bit difference in one step's output can move a later row's code
    by one, which the float32 tolerance does not cover."""
    P = config.max_pages_per_seq
    cache = PagedKVCache.create(
        num_pages=P,
        page_size=config.page_size,
        n_kv_heads=model.n_kv_heads,
        head_dim=model.head_dim,
        max_seqs=1,
        max_pages_per_seq=P,
        dtype=torch.int8 if config.kv_dtype == "int8" else torch.float32,
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
        if forced is not None:
            hidden = torch.as_tensor(forced[len(outs) - 1], device=model.device)
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


def oracle_draft_fn(ref_outputs: dict[int, list[np.ndarray]]) -> DraftFn:
    """A draft function that drafts the TRUE next inputs, from a completed
    :func:`run_reference` replay: the full-accept end of the accept /
    rollback range wherever the engine's rows equal the replay's bit for
    bit. Positions past the replay fall back to the greedy draft."""

    def draft(model: ToyModel, req: ServeRequest, x, j: int):
        # draft j's input is next_input(hidden_{n+j-1}) where n tokens are
        # committed so far (draft 0 == pending_x == next_input(hidden_{n-1}))
        idx = len(req.generated) + j - 1
        hiddens = ref_outputs.get(req.req_id, [])
        if 0 <= idx < len(hiddens):
            return model.next_input(
                torch.as_tensor(hiddens[idx], device=model.device)
            )
        return model.draft_next(x)

    return draft
