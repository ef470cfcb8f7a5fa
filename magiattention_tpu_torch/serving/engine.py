"""Continuous-batching serving engine.

The port's counterpart of ``magiattention_tpu/serving/engine.py``.
``ServeEngine.step()`` is one scheduler tick: admit + prefill newly admitted
requests, then run ONE decode step for every occupied slot (the batch is a
static ``(max_slots, hq, d)`` block — empty slots carry zero queries and
length 0), then retire completed requests. A long prompt never stalls other
requests for more than a tick.

- ``spec_tokens`` k > 1 switches the decode phase to speculative verify:
  each tick drafts k-1 extra inputs (``draft_fn``, default the model's
  greedy self-draft), appends all k rows, verifies them in ONE call,
  commits the longest accepted prefix, and rolls the rejected rows back
  (lengths and pages; released pages get their int8 scales reset). Draft
  input 0 is always the true ``pending_x``, so at least one token commits
  per tick.
- ``kv_dtype='int8'`` stores the KV pages as int8 codes with per-(page, kv
  head) float32 scales; decode reads them through the int8 kernel, and
  verify on an int8 cache through the dequantized gather + FFA.

The engine runs where its model's weights are: on a card, through the
hand-written kernels (FFA forward for prefill, the paged-decode, spec or
int8 kernel for decode); on the CPU, through their plain versions.
``decode_shards > 1`` runs the decode step head-sharded (B10 once per
kv-head shard, one card per shard) where the sharded rung is feasible,
and on the next feasible rung where it is not (too few cards, an int8
cache, a verify step), as the JAX engine does; ``pool_shards``
partitions the page pool. ``step()`` returns the tick's stats dict, which
under MAGI_ATTENTION_TELEMETRY=1 is also the tick's ``serve_step`` record
(the JAX package's fields; ``wall_ms`` is the host's time for the tick).

Under MAGI_ATTENTION_BACKEND_SERVE_DECODE=gather_ffa the decode tick runs
the replay oracle's own calls: attention through the gather + FFA rung,
and the model's products one row at a time (a row of a multi-row matmul
may differ in its last bit from the same row alone, on the CPU and on a
card), so the engine's rows equal :func:`.reference.run_reference`'s bit
for bit. Unpinned, the products stay batched over slots and draft rows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from .. import telemetry
from ..env import backend as env_backend
from ..env import serve as env_serve
from ..kernels.paged_kv import PagedKVCache, append_kv, rollback_kv
from .cache import PagePool
from .decode import decode_attn_step, verify_attn_step
from .model import ToyModel
from .prefill import prefill_request
from .scheduler import Scheduler, ServeRequest

__all__ = ["DraftFn", "ServeConfig", "ServeEngine", "ServeRequest"]


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


# draft_fn(model, request, current_input, draft_index) -> next draft input
DraftFn = Callable[[ToyModel, ServeRequest, torch.Tensor, int], torch.Tensor]


def _greedy_draft(
    model: ToyModel, req: ServeRequest, x: torch.Tensor, j: int
) -> torch.Tensor:
    return model.draft_next(x)


def _rows_alone(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``x`` one at a time (the replay's calls)."""
    return torch.cat([fn(row) for row in x.split(1)])


def _check_supported(config: ServeConfig) -> None:
    if config.kv_dtype not in ("float32", "int8"):
        raise ValueError(
            f"kv_dtype={config.kv_dtype!r} not in ('float32', 'int8')"
        )
    if config.spec_tokens < 1:
        raise ValueError(f"spec_tokens={config.spec_tokens} must be >= 1")


class ServeEngine:
    """Drives a :class:`ToyModel`-shaped model over a shared paged cache,
    on the model's device."""

    def __init__(
        self,
        model: ToyModel,
        config: ServeConfig,
        draft_fn: DraftFn | None = None,
    ) -> None:
        _check_supported(config)
        self.model = model
        self.config = config
        self.draft_fn = draft_fn or _greedy_draft
        self.cache = PagedKVCache.create(
            num_pages=config.num_pages,
            page_size=config.page_size,
            n_kv_heads=model.n_kv_heads,
            head_dim=model.head_dim,
            max_seqs=config.max_slots,
            max_pages_per_seq=config.max_pages_per_seq,
            dtype=torch.int8 if config.kv_dtype == "int8" else torch.float32,
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
        """Admit, prefill, decode (one token or a spec_tokens draft window)
        per active slot, retire. Returns the tick's stats dict."""
        t0 = time.perf_counter()
        cfg = self.config
        sched = self.scheduler
        model = self.model
        spec_k = cfg.spec_tokens
        admitted = evicted = completed = 0
        prefill_tokens = decode_tokens = 0
        draft_attempted = draft_accepted = 0
        replay_exact = env_backend.serve_decode_pin() == "gather_ffa"

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

        # 2. page growth for this tick's tokens (may evict — including a
        # request admitted above, whose prefill is then redone after
        # re-admission)
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is None or req.pending_x is None:
                continue
            self.cache, n_evicted = sched.ensure_capacity(
                self.cache, req, req.length + spec_k
            )
            evicted += n_evicted

        # 3. decode: one token (spec_k == 1) or draft + verify (spec_k > 1)
        # per surviving slot, one kernel launch
        q_rows: dict[int, torch.Tensor] = {}
        draft_xs: dict[int, list[torch.Tensor]] = {}
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is None or req.pending_x is None:
                continue
            xs = [req.pending_x]
            for j in range(1, spec_k):
                xs.append(self.draft_fn(model, req, xs[-1], j))
            x_block = torch.stack(xs)  # (spec_k, d_model)
            if replay_exact:  # the replay's one-row products
                q, k, v = (torch.cat(t) for t in zip(*map(model.qkv, x_block.split(1))))
            else:
                q, k, v = model.qkv(x_block)
            self.cache = append_kv(self.cache, slot, k, v)
            req.length += spec_k
            q_rows[slot] = q
            draft_xs[slot] = xs
            draft_attempted += spec_k

        if q_rows:
            zero = torch.zeros(
                (spec_k, model.n_heads, model.head_dim), device=model.device
            )
            q_batch = torch.stack(
                [q_rows.get(s, zero) for s in range(cfg.max_slots)]
            )
            host_lengths = tuple(
                sched.slots[s].length if s in q_rows else 0
                for s in range(cfg.max_slots)
            )
            if spec_k == 1:
                out, _ = decode_attn_step(
                    q_batch[:, 0], self.cache, cfg.softmax_scale, host_lengths,
                    shards=cfg.decode_shards,
                )
                out = out[:, None]
            else:
                out, _ = verify_attn_step(
                    q_batch, self.cache, host_lengths, cfg.softmax_scale
                )
            slots = sorted(q_rows)
            # (n, spec_k, d_model): row j is right iff draft inputs 0..j
            # were (causal rows never see later garbage)
            project = (
                (lambda o: _rows_alone(model.project, o)) if replay_exact else model.project
            )
            hidden = project(out[slots].flatten(0, 1)).reshape(len(slots), spec_k, -1)
            hidden_host = hidden.cpu().numpy()
            now = time.perf_counter()
            for i, slot in enumerate(slots):
                req = sched.slots[slot]
                xs = draft_xs[slot]
                # longest accepted prefix: draft 0 is the true pending_x,
                # so row 0 is always right; row j commits iff its input
                # equals what row j-1's output implies
                accept = 1
                while accept < spec_k and torch.equal(
                    xs[accept], model.next_input(hidden[i, accept - 1])
                ):
                    accept += 1
                commit = min(accept, req.max_new_tokens - len(req.generated))
                req.generated.extend(hidden_host[i, :commit])
                if req.first_token_time is None:
                    req.first_token_time = now
                req.pending_x = model.next_input(hidden[i, commit - 1])
                decode_tokens += commit
                draft_accepted += commit
                if commit < spec_k:  # roll back the rejected rows + pages
                    req.length -= spec_k - commit
                    self.cache = rollback_kv(self.cache, slot, req.length)
                    self.cache = sched.shrink_to_length(self.cache, req)

        # 4. retirement
        for slot in range(cfg.max_slots):
            req = sched.slots[slot]
            if req is not None and req.done:
                req.finish_time = time.perf_counter()
                self.cache = sched.finish(self.cache, req)
                self.finished.append(req)
                completed += 1

        self.step_count += 1
        stats = dict(
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
            kv_dtype=cfg.kv_dtype,
            shards=cfg.decode_shards,
            spec_k=spec_k,
            draft_attempted=draft_attempted,
            draft_accepted=draft_accepted,
            accept_rate=(
                draft_accepted / draft_attempted if draft_attempted else 0.0
            ),
        )
        if telemetry.enabled():
            telemetry.record_event("serve_step", **stats)
            telemetry.inc("serve.steps")
        return stats

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
