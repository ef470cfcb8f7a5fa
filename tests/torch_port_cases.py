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


# ---------------------------------------------------------------------------
# the JAX package's native host library, which its planners need
# ---------------------------------------------------------------------------


def _native_so():
    """(the JAX build module, the path its ``get_lib`` builds and loads)."""
    import hashlib

    from magiattention_tpu.csrc_backend import build

    digest = hashlib.sha256(build._SRC.read_bytes()).hexdigest()[:16]
    return build, build._cache_dir() / f"magi_host_{digest}.so"


def warm_jax_native():
    """Load the JAX package's native host library (``csrc_backend/build.py``
    ``get_lib``), recovering from a build race another process won.

    The JAX planners call the library with no Python fallback
    (``meta/container/slice.py:69-78``), and ``get_lib`` memoizes a failed
    build. Two processes that build it at once into the same cache write
    one fixed ``magi_host_<hash>.so.tmp`` (``build.py:33-39``): the one that
    renames second gets ``FileNotFoundError``, and every planner call of
    that process then raises. So: the first build runs under an exclusive
    lock on the cache directory (processes that build through this helper
    take turns); and where ``get_lib`` raises but the library exists, the
    memoized failure is dropped and the library loaded once more. It is the
    very library the JAX package built; nothing of the package changes.
    Where the library does not exist, the error is raised."""
    import fcntl
    import os

    build, so = _native_so()
    if build._LIB is None and build._LIB_ERR is None and not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(so.parent, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                return build.get_lib()
            except ImportError:
                pass  # recovered below where another process built it
        finally:
            os.close(fd)  # releases the lock
    try:
        return build.get_lib()
    except ImportError:
        if not so.exists():
            raise
        build._LIB_ERR = None
        return build.get_lib()


# Every xdist worker imports this module while it collects, before any
# worker runs a test: the build happens here, once, under the lock, so no
# test of any worker races another to build it.
try:
    warm_jax_native()
except ImportError:
    pass  # the port's fixtures raise it where a test needs the library



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
    (n, 2) int64 arrays, a single range its (start, end), and enums their
    values. A DispatchMeta adds its
    derived position_ids, unpermute_index and per-rank host ranges."""
    import dataclasses
    import enum

    out: dict = {}
    if hasattr(obj, "to_naive_ranges"):
        out[name] = np.asarray(obj.to_naive_ranges(), np.int64).reshape(-1, 2)
    elif type(obj).__name__ == "AttnRange":
        out[name] = np.asarray([obj.start, obj.end], np.int64)
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
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


def dyn_worker(rank: int, world: int, init_file: str, out_dir: str, cases: list) -> None:
    """One rank of the gloo group for the qo-comm cross-check
    (tests/test_torch_dynamic.py): every case (name, q/k ranges, types,
    env) through the port's key -> dispatch -> calc_attn -> undispatch
    with max-logits under MAGI_ATTENTION_QO_COMM=1, forward and the
    backward of ``sum(out * dO)``; results and the plan's comm rows to
    ``out_dir/<name>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world
    )
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr

    try:
        for name, qr, kr, types, env in cases:
            env = {"MAGI_ATTENTION_QO_COMM": "1", **env}
            os.environ.update(env)
            key = api.magi_attn_flex_key(
                qr, kr, types, CP_SEQ, CP_SEQ, cp_group=dist.group.WORLD, device="cpu",
                chunk_size=CP_CHUNK,
            )
            q, k, v, do = (torch.from_numpy(a) for a in cp_inputs(len(name)))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out_d, meta = api.calc_attn(
                api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
                api.dispatch(leaves[2], key, role="kv"), key, return_max_logits=True,
            )
            out = api.undispatch(out_d, key)
            (out * do).sum().backward()
            mgr = _mgr(key)
            np.savez(
                os.path.join(out_dir, f"{name}_{rank}.npz"),
                out=out.detach().numpy(), lse=meta.lse.numpy(),
                dq=leaves[0].grad.numpy(), dk=leaves[1].grad.numpy(),
                dv=leaves[2].grad.numpy(), ml=meta.max_logits.numpy(),
                runtime=type(mgr.runtime).__name__,
                comm_rows=np.asarray(list(mgr.dynamic_plan.comm_rows().values())),
            )
            for key_ in env:
                os.environ.pop(key_)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# the roll cases (tests/test_torch_roll.py): the CP shapes, narrow rows
ROLL_WIDTH = 8


def roll_inputs(seed: int):
    """float32 x ``[CP_SEQ, 2, ROLL_WIDTH]`` and the cotangent g."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((CP_SEQ, 2, ROLL_WIDTH)).astype(np.float32) for _ in range(2)]


def roll_worker(rank: int, world: int, init_file: str, out_dir: str, shifts: list) -> None:
    """One rank of the gloo group: for each shift, the port's ``roll`` of
    the dispatched x (a causal key), undispatched, and the gradient of
    ``sum(rolled * g)``; results to ``out_dir/roll<shift>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api

    try:
        key = api.magi_attn_flex_key([[0, CP_SEQ]], [[0, CP_SEQ]], [1], CP_SEQ, CP_SEQ,
                                     cp_group=dist.group.WORLD, device="cpu", chunk_size=CP_CHUNK)
        for shift in shifts:
            x, g = (torch.from_numpy(a) for a in roll_inputs(abs(shift)))
            x = x.requires_grad_(True)
            out = api.undispatch(api.roll(api.dispatch(x, key), key, shift), key)
            (out * g).sum().backward()
            np.savez(os.path.join(out_dir, f"roll{shift}_{rank}.npz"),
                     out=out.detach().numpy(), grad=x.grad.numpy())
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# the re-keying cases (tests/test_torch_rekey.py): the JAX package's
# test_rekey.py shapes
REKEY_SEQ, REKEY_CHUNK, REKEY_HQ, REKEY_HK, REKEY_D = 256, 16, 2, 1, 32


def rekey_inputs(seed: int):
    """float32 q, k, v and dO of the re-keying cases, natural order."""
    rng = np.random.default_rng(seed)
    shapes = ((REKEY_SEQ, REKEY_HQ, REKEY_D), (REKEY_SEQ, REKEY_HK, REKEY_D),
              (REKEY_SEQ, REKEY_HK, REKEY_D), (REKEY_SEQ, REKEY_HQ, REKEY_D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def rekey_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of the gloo group: a causal dispatch key, then each new
    mask re-keyed onto it (full by ``make_flex_key_for_new_mask_after_
    dispatch``, a (32, 0) window by the varlen form), q/k/v dispatched by
    the first key, ``calc_attn`` under the new one, undispatched, and the
    backward of ``sum(out * dO)``; the keys' partitions and position ids,
    the refused causal window, and the cross-attention args. Results to
    ``out_dir/<case>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges

    group, s = dist.group.WORLD, REKEY_SEQ
    try:
        key1 = api.magi_attn_flex_key([[0, s]], [[0, s]], [1], s, s, cp_group=group, device="cpu",
                                      chunk_size=REKEY_CHUNK)
        new_keys = {
            "full": api.make_flex_key_for_new_mask_after_dispatch([[0, s]], [[0, s]], [0], key1),
            "window": api.make_varlen_key_for_new_mask_after_dispatch(
                [0, s], [0, s], key1, causal=False, window_size=(32, 0)),
        }
        most_recent = api.get_most_recent_key() is new_keys["window"]
        for i, (name, key2) in enumerate(new_keys.items()):
            q, k, v, do = (torch.from_numpy(a) for a in rekey_inputs(i))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out_d, meta = api.calc_attn(
                api.dispatch(leaves[0], key1), api.dispatch(leaves[1], key1, role="kv"),
                api.dispatch(leaves[2], key1, role="kv"), key2,
            )
            out = api.undispatch(out_d, key2)
            (out * do).sum().backward()
            np.savez(
                os.path.join(out_dir, f"{name}_{rank}.npz"),
                out=out.detach().numpy(), lse=meta.lse.numpy(), dq=leaves[0].grad.numpy(),
                dk=leaves[1].grad.numpy(), dv=leaves[2].grad.numpy(),
                partitions=np.asarray(_mgr(key2).dispatch_meta_q.partitions),
                fixed=np.asarray(key2.fixed_partitions),
                position_ids=np.asarray(_mgr(key2).dispatch_meta_q.position_ids),
                key1_position_ids=np.asarray(_mgr(key1).dispatch_meta_q.position_ids),
                distinct=key1 != key2, most_recent=most_recent,
            )
        try:
            api.make_varlen_key_for_new_mask_after_dispatch(
                [0, s], [0, s], key1, causal=True, window_size=(32, 0))
            refused = False
        except ValueError:
            refused = True
        args = _mgr(key1).get_xattn_args(
            AttnRanges.from_ranges([[0, 128], [128, s]]), AttnRanges.from_ranges([[0, 48], [48, 96]]),
            AttnMaskType.FULL,
        )
        np.savez(
            os.path.join(out_dir, f"xattn_{rank}.npz"), refused=refused,
            position_ids=np.asarray(_mgr(key1).dispatch_meta_q.position_ids),
            **{f"q{r}": a.q_ranges for r, a in enumerate(args)},
            **{f"k{r}": a.k_ranges for r, a in enumerate(args)},
        )
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# the cp trainer's config (tests/test_torch_llama_cp.py): the JAX package's
# tests/test_models/test_llama.py shapes
LLAMA_CP_CFG = dict(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, ffn_hidden=128, dtype="float32",
)
LLAMA_CP_SEQ, LLAMA_CP_CHUNK = 128, 16


def llama_cp_data():
    """Tokens and next-token labels, -100 at each document's end."""
    s = LLAMA_CP_SEQ
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, LLAMA_CP_CFG["vocab_size"], s).astype(np.int32)
    labels = np.roll(tokens, -1)
    labels[s // 2 - 1 :: s // 2] = -100
    return tokens, labels


def llama_cp_worker(rank: int, world: int, init_file: str, out_dir: str, tree: dict) -> None:
    """One rank of the gloo group: the port's Llama ``value_and_grad`` at
    cp = world over the JAX parameters ``tree`` (numpy), counting its
    ``all_reduce`` calls; loss, gradients and count to
    ``out_dir/llama_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models import llama

    s = LLAMA_CP_SEQ
    try:
        key = api.magi_attn_flex_key([[0, s // 2], [s // 2, s]], [[0, s // 2], [s // 2, s]], [1, 1],
                                     s, s, cp_group=dist.group.WORLD, device="cpu",
                                     chunk_size=LLAMA_CP_CHUNK)
        params = llama.params_from_numpy(tree, "cpu")
        tokens, labels = (torch.from_numpy(a) for a in llama_cp_data())
        calls, all_reduce = [], dist.all_reduce

        def counted(*args, **kwargs):
            calls.append(1)
            return all_reduce(*args, **kwargs)

        dist.all_reduce = counted
        try:
            loss, grads = llama.value_and_grad(params, llama.LlamaConfig(**LLAMA_CP_CFG), tokens,
                                               labels, key)
        finally:
            dist.all_reduce = all_reduce
        np.savez(os.path.join(out_dir, f"llama_{rank}.npz"), loss=loss.numpy(),
                 all_reduce_calls=len(calls), **{f"g{i}": g.numpy() for i, g in enumerate(grads)})
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()
