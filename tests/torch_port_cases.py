"""Shared small inputs for the PyTorch port's CPU tests (tests/test_torch_*.py).

Every case is band-slice metadata at a small size (sequences <= 256), given
to the JAX package and to the port as the same numpy arrays.

Every port test file imports this module, which runs torch's intra-op
work on the calling thread alone (one thread per process). The suite runs
several xdist workers on a few cores beside the JAX package's
timing-sensitive tests, and torch's default of one thread per core would
oversubscribe them. One thread, not two: with JAX's runtime in the same
process, a torch worker thread now and then computes exp/log less
accurately (measured on the CPU: a plain softmax's lse off by up to
4.6e-5 at lse = 5 on the rows the second thread took, in one process in
five; never on the calling thread), so a second thread made float32
results vary from process to process.
"""

from __future__ import annotations

import numpy as np
import torch

TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)

BAND_INF = 1 << 30


def _bands(qr, kr, types):
    """(d_lo, d_hi) of typed slices (0 full, 1 causal, 2 inv, 3 bi)."""
    qr, kr, t = np.asarray(qr), np.asarray(kr), np.asarray(types)
    causal = (t == 1) | (t == 3)
    inv = (t == 2) | (t == 3)
    hi = np.where(causal, kr[:, 1] - qr[:, 1], BAND_INF)
    lo = np.where(inv, kr[:, 0] - qr[:, 0], -BAND_INF)
    return lo.astype(np.int32), hi.astype(np.int32)


def _case(qr, kr, lo, hi, sq, sk):
    return (
        np.asarray(qr, np.int32), np.asarray(kr, np.int32),
        np.asarray(lo, np.int32), np.asarray(hi, np.int32), sq, sk,
    )


def _typed(qr, kr, types, sq, sk):
    return _case(qr, kr, *_bands(qr, kr, types), sq, sk)


# name -> (q_ranges, k_ranges, d_lo, d_hi, seqlen_q, seqlen_k)
MASKS = {
    "full": _typed([[0, 96]], [[0, 128]], [0], 96, 128),
    "causal": _typed([[0, 128]], [[0, 128]], [1], 128, 128),
    "invcausal": _typed([[0, 128]], [[0, 128]], [2], 128, 128),
    "bicausal": _typed([[0, 96]], [[0, 128]], [3], 96, 128),
    "varlen": _typed(
        [[0, 40], [40, 100], [100, 160]], [[0, 40], [40, 100], [100, 160]],
        [1, 0, 1], 160, 160,
    ),
    "sliding_band": _case([[0, 128]], [[0, 128]], [-16], [0], 128, 128),
    # a paged-prefill chunk: 24 queries at positions 16.. over 64 gathered
    # rows of which kv_len = 40 are stored
    "paged_prefill": _case([[0, 24]], [[0, 40]], [-BAND_INF], [16], 24, 64),
    # rows [48, 80) no slice covers
    "uncovered": _typed(
        [[0, 48], [80, 128]], [[0, 64], [32, 128]], [1, 0], 128, 128
    ),
}


def qkv(rng: np.random.Generator, sq: int, sk: int, hq: int, hk: int, d: int):
    """float32 q ``[sq, hq, d]``, k/v ``[sk, hk, d]`` drawn from ``rng``."""
    q = rng.standard_normal((sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((sk, hk, d)).astype(np.float32)
    return q, k, v


def meta_fields(obj, name: str = "") -> dict:
    """A planner output of either package (dispatch, comm or calc meta,
    or a list of them) as a flat dict of field path -> numpy array or plain
    value, so the two packages' plans compare field by field. Walks
    dataclasses (public fields), lists and tuples; range lists become
    (n, 2) int64 arrays and enums their values. A DispatchMeta adds its
    derived position_ids, unpermute_index and per-rank host ranges."""
    import dataclasses
    import enum

    out: dict = {}
    if hasattr(obj, "to_naive_ranges"):
        out[name] = np.asarray(obj.to_naive_ranges(), np.int64).reshape(-1, 2)
    elif isinstance(obj, enum.Enum):
        out[name] = obj.value
    elif isinstance(obj, np.ndarray):
        out[name] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if not f.name.startswith("_"):
                out.update(meta_fields(getattr(obj, f.name), f"{name}.{f.name}"))
        if type(obj).__name__ == "DispatchMeta":
            for prop in ("position_ids", "unpermute_index", "host_ranges_per_rank"):
                out.update(meta_fields(getattr(obj, prop), f"{name}.{prop}"))
    elif isinstance(obj, (list, tuple)):
        out[f"{name}#len"] = len(obj)
        for i, x in enumerate(obj):
            out.update(meta_fields(x, f"{name}[{i}]"))
    else:
        out[name] = obj
    return out


def assert_same_fields(port, ref, msg: str = "") -> None:
    """Every field of the port's meta equals the JAX package's."""
    a, b = meta_fields(port), meta_fields(ref)
    assert a.keys() == b.keys(), f"{msg}: fields {sorted(a.keys() ^ b.keys())}"
    for key in a:
        if isinstance(b[key], np.ndarray) or isinstance(a[key], np.ndarray):
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), f"{msg}{key}"
        else:
            assert a[key] == b[key], f"{msg}{key}: {a[key]!r} != {b[key]!r}"


# ---------------------------------------------------------------------------
# the context-parallel cross-check (tests/test_torch_cp.py): one process per
# rank over gloo, inputs made here from numpy seeds on both sides
# ---------------------------------------------------------------------------

CP_SEQ, CP_CHUNK, CP_HQ, CP_HK, CP_D = 512, 32, 4, 2, 64


def cp_inputs(seed: int):
    """float32 q, k, v and dO of the CP cases, natural order."""
    q, k, v = qkv(np.random.default_rng(seed), CP_SEQ, CP_SEQ, CP_HQ, CP_HK, CP_D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def cp_worker(rank: int, world: int, init_file: str, out_dir: str, cases: list) -> None:
    """One rank of the gloo group: every case (name, q/k ranges, types,
    overlap degree, env) through the port's key -> dispatch -> calc_attn
    -> undispatch (with max-logits), forward and backward, then GroupCast and GroupReduce of
    the first multi-stage plan; results to ``out_dir/<name>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world
    )
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.comm.primitives import group_cast_rows, group_reduce_rows
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig

    group = dist.group.WORLD
    try:
        for name, qr, kr, types, degree, env in cases:
            os.environ.update(env)
            config = DistAttnConfig(overlap_config=OverlapConfig(degree=degree, min_chunk_size=32))
            key = api.magi_attn_flex_key(
                qr, kr, types, CP_SEQ, CP_SEQ, cp_group=group, device="cpu",
                chunk_size=CP_CHUNK, dist_attn_config=config,
            )
            q, k, v, do = (torch.from_numpy(a) for a in cp_inputs(len(name)))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            q_d = api.dispatch(leaves[0], key)
            k_d = api.dispatch(leaves[1], key, role="kv")
            v_d = api.dispatch(leaves[2], key, role="kv")
            out_d, meta = api.calc_attn(q_d, k_d, v_d, key, return_max_logits=True)
            out = api.undispatch(out_d, key)
            (out * do).sum().backward()
            runtime = _mgr(key).runtime
            np.savez(
                os.path.join(out_dir, f"{name}_{rank}.npz"),
                out=out.detach().numpy(), lse=meta.lse.numpy(),
                dq=leaves[0].grad.numpy(), dk=leaves[1].grad.numpy(),
                dv=leaves[2].grad.numpy(), ml=meta.max_logits.numpy(),
                stages=runtime.num_stages,
            )
            for key_ in env:
                os.environ.pop(key_)
            if runtime.num_stages < 2 or os.path.exists(os.path.join(out_dir, f"comm_{rank}.npz")):
                continue
            # GroupCast / GroupReduce of this plan's stages on seeded rows
            rng = np.random.default_rng(1000 + rank)
            shard = runtime.calc_meta.kv_shard_len
            x = torch.from_numpy(rng.standard_normal((shard, 3)).astype(np.float32))
            res = {"case": name}
            for st, plan in enumerate(runtime.cast_plans):
                xg = x.clone().requires_grad_(True)
                buf = group_cast_rows(xg, plan, group)
                y = torch.from_numpy(rng.standard_normal(tuple(buf.shape)).astype(np.float32))
                (buf * y).sum().backward()
                res[f"cast{st}"] = buf.detach().numpy()
                res[f"y{st}"] = y.numpy()
                res[f"reduce{st}"] = group_reduce_rows(y, plan, group, shard).numpy()
                res[f"grad{st}"] = xg.grad.numpy()
            np.savez(os.path.join(out_dir, f"comm_{rank}.npz"), x=x.numpy(), **res)
    finally:
        dist.destroy_process_group()
