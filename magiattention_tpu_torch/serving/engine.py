"""Continuous-batching serving engine.

The port's counterpart of ``magiattention_tpu/serving/engine.py``.
``ServeEngine.step()`` is one scheduler tick: admit + prefill newly admitted
requests, then run ONE decode step for every occupied slot (the batch is a
static ``(max_slots, hq, d)`` block — empty slots carry zero queries and
length 0), then retire completed requests. A long prompt never stalls other
requests for more than a tick.

The engine runs where its model's weights are: on a card, prefill goes
through the FFA forward kernel and decode through the paged-decode kernel;
on the CPU, through their plain versions.

Not ported yet (they raise ``NotImplementedError`` naming the ROADMAP
item): ``spec_tokens > 1`` (speculative verify, kernel B11),
``kv_dtype='int8'`` (int8 pages, kernel B12) and ``decode_shards > 1`` (the
head-sharded decode). Telemetry is left out; ``step()`` still returns the
tick's stats dict.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..env import serve as env_serve
from ..kernels.paged_kv import PagedKVCache, append_kv
from .cache import PagePool
from .decode import decode_attn_step
from .model import ToyModel
from .prefill import prefill_request
from .scheduler import Scheduler, ServeRequest

__all__ = ["ServeConfig", "ServeEngine", "ServeRequest"]


@dataclass(frozen=True)
class ServeConfig:
    """Static-shape envelope of one engine instance. Everything here fixes
    a tensor shape or a traversal schedule, so two engines with equal
    configs replay each other exactly."""

    page_size: int = 16
    num_pages: int = 64
    max_slots: int = 4
    max_pages_per_seq: int = 16
    prefill_chunk: int = 64
    softmax_scale: float | None = None
    kv_dtype: str = "float32"
    spec_tokens: int = 1
    decode_shards: int = 1
    pool_shards: int = 1  # page-pool partitions (scheduler routing)

    @classmethod
    def from_env(cls) -> "ServeConfig":
        num_pages = env_serve.serve_num_pages()
        return cls(
            page_size=env_serve.serve_page_size(),
            num_pages=num_pages,
            max_slots=env_serve.serve_max_slots(),
            max_pages_per_seq=num_pages,
            prefill_chunk=env_serve.serve_prefill_chunk(),
            kv_dtype=env_serve.serve_kv_dtype(),
            spec_tokens=env_serve.serve_spec_tokens(),
            decode_shards=env_serve.serve_shards(),
            pool_shards=env_serve.serve_pool_shards(),
        )


def _check_supported(config: ServeConfig) -> None:
    if config.kv_dtype not in ("float32", "int8"):
        raise ValueError(
            f"kv_dtype={config.kv_dtype!r} not in ('float32', 'int8')"
        )
    if config.spec_tokens < 1:
        raise ValueError(f"spec_tokens={config.spec_tokens} must be >= 1")
    if config.spec_tokens > 1:
        raise NotImplementedError(
            "spec_tokens > 1 needs the speculative-verify decode kernel "
            "(ROADMAP queue B item 11), not ported yet"
        )
    if config.kv_dtype == "int8":
        raise NotImplementedError(
            "kv_dtype='int8' needs the int8 paged-decode kernel "
            "(ROADMAP queue B item 12), not ported yet"
        )
    if config.decode_shards > 1:
        raise NotImplementedError(
            "decode_shards > 1 needs the head-sharded decode rung "
            "(ROADMAP queue A item 8), not ported yet"
        )


class ServeEngine:
    """Drives a :class:`ToyModel`-shaped model over a shared paged cache,
    on the model's device."""

    def __init__(self, model: ToyModel, config: ServeConfig) -> None:
        _check_supported(config)
        self.model = model
        self.config = config
        self.cache = PagedKVCache.create(
            num_pages=config.num_pages,
            page_size=config.page_size,
            n_kv_heads=model.n_kv_heads,
            head_dim=model.head_dim,
            max_seqs=config.max_slots,
            max_pages_per_seq=config.max_pages_per_seq,
            dtype=torch.float32,
            device=model.device,
        )
        self.scheduler = Scheduler(
            PagePool(config.num_pages, config.pool_shards),
            config.max_slots,
            config.page_size,
        )
        self.step_count = 0
        self.finished: list[ServeRequest] = []

    # -- request intake ---------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        if req.prompt_len < 1:
            raise ValueError(f"request {req.req_id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.req_id}: max_new_tokens < 1")
        req.submit_time = time.perf_counter()
        self.scheduler.submit_request(req)

    # -- one tick ---------------------------------------------------------
    @torch.no_grad()
    def step(self) -> dict:
        """Admit, prefill, decode one token per active slot, retire.
        Returns the tick's stats dict."""
        t0 = time.perf_counter()
        cfg = self.config
        sched = self.scheduler
        model = self.model
        admitted = evicted = completed = 0
        prefill_tokens = decode_tokens = 0

        # 1. admission + prefill
        self.cache, newly = sched.admit(self.cache)
        for req in newly:
            self.cache, last_hidden = prefill_request(
                model, self.cache, req.slot, req.prompt,
                cfg.prefill_chunk, cfg.softmax_scale,
            )
            req.length = req.prompt_len
            req.pending_x = model.next_input(last_hidden)
            prefill_tokens += req.prompt_len
            admitted += 1

        # 2. page growth for this tick's token (may evict — including a
        # request admitted above, whose prefill is then redone after
        # re-admission)
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is None or req.pending_x is None:
                continue
            self.cache, n_evicted = sched.ensure_capacity(
                self.cache, req, req.length + 1
            )
            evicted += n_evicted

        # 3. decode: one token per surviving slot, one kernel launch
        q_rows: dict[int, torch.Tensor] = {}
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is None or req.pending_x is None:
                continue
            q, k, v = model.qkv(req.pending_x[None])
            self.cache = append_kv(self.cache, slot, k, v)
            req.length += 1
            q_rows[slot] = q[0]
            decode_tokens += 1

        if q_rows:
            zero_row = torch.zeros(
                (model.n_heads, model.head_dim), device=model.device
            )
            q_batch = torch.stack(
                [q_rows.get(s, zero_row) for s in range(cfg.max_slots)]
            )
            out, _ = decode_attn_step(q_batch, self.cache, cfg.softmax_scale)
            slots = sorted(q_rows)
            hidden = model.project(out[slots])  # (n, d_model)
            hidden_host = hidden.cpu().numpy()
            now = time.perf_counter()
            for i, slot in enumerate(slots):
                req = sched.slots[slot]
                req.generated.append(hidden_host[i])
                if req.first_token_time is None:
                    req.first_token_time = now
                req.pending_x = model.next_input(hidden[i])

        # 4. retirement
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is not None and req.done:
                req.finish_time = time.perf_counter()
                self.cache = sched.finish(self.cache, req)
                self.finished.append(req)
                completed += 1

        self.step_count += 1
        return dict(
            step=self.step_count,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            occupancy=len(sched.active) / cfg.max_slots,
            pages_in_use=sched.pool.used_count,
            waiting=len(sched.waiting),
            admitted=admitted,
            evicted=evicted,
            completed=completed,
            prefill_tokens=prefill_tokens,
            decode_tokens=decode_tokens,
        )

    # -- full drain -------------------------------------------------------
    def run(
        self, requests: list[ServeRequest], max_steps: int = 100_000
    ) -> list[ServeRequest]:
        """Submit ``requests`` and tick until every one completes."""
        for req in requests:
            self.submit(req)
        while self.scheduler.has_work():
            self.step()
            if self.step_count > max_steps:
                raise RuntimeError(
                    f"serving loop exceeded {max_steps} steps "
                    f"({len(self.finished)}/{len(requests)} done)"
                )
        return self.finished
