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


# the CP baselines (tests/test_torch_baselines.py): the JAX package's
# tests/test_parallel/test_baselines.py shapes, with GQA 2 and 8 q heads
# so that every head split keeps whole groups
BASE_SEQ, BASE_HQ, BASE_HK, BASE_D = 256, 8, 4, 32
BASE_MASKS = {
    "full": ([[0, BASE_SEQ]], [[0, BASE_SEQ]], [0]),
    "causal": ([[0, BASE_SEQ]], [[0, BASE_SEQ]], [1]),
    "varlen_causal": ([[0, 96], [96, 160], [160, BASE_SEQ]],) * 2 + ([1, 1, 1],),
}
# name -> (function of magiattention_tpu_torch.parallel, mesh, the data's
# sharding axes, the ring dispatch (ring size, sharding) or None, kwargs);
# a mesh is (axis names, shape), or ("loongtrain", (U, O, I), placement)
LT_AXES = ("rp_out", "rp_in", "sp")
BASELINES = {
    "ring_zigzag": ("ring_attn", (("cp",), (4,)), ("cp",), (4, "zigzag"), {"sharding": "zigzag"}),
    "ring_contig": ("ring_attn", (("cp",), (4,)), ("cp",), (4, "contig"), {"sharding": "contig"}),
    "ring_ag_zigzag": ("ring_attn_allgather", (("cp",), (4,)), ("cp",), (4, "zigzag"),
                       {"sharding": "zigzag"}),
    "ring_ag_contig": ("ring_attn_allgather", (("cp",), (4,)), ("cp",), (4, "contig"),
                       {"sharding": "contig"}),
    "ulysses": ("ulysses_attn", (("cp",), (4,)), ("cp",), None, {}),
    "usp": ("usp_attn", (("rp", "sp"), (2, 2)), ("rp", "sp"), None, {}),
    "loongtrain_zigzag": ("loongtrain_attn", (LT_AXES[:2], (2, 2)), LT_AXES[:2], (4, "zigzag"),
                          {"sharding": "zigzag"}),
    "loongtrain_contig": ("loongtrain_attn", (LT_AXES[:2], (2, 2)), LT_AXES[:2], (4, "contig"),
                          {"sharding": "contig"}),
    "loongtrain_2d_head_first": ("loongtrain_attn", ("loongtrain", (2, 1, 2), "head_first"), LT_AXES,
                                 (2, "zigzag"), {"ulysses_axis": "sp"}),
    "loongtrain_2d_context_first": ("loongtrain_attn", ("loongtrain", (2, 1, 2), "context_first"),
                                    LT_AXES, (2, "zigzag"), {"ulysses_axis": "sp"}),
    "hybrid": ("hybrid_cp_attn", (("cp_inter", "cp_intra"), (2, 2)), ("cp_inter", "cp_intra"), None, {}),
    "allgather": ("allgather_attn", (("cp",), (4,)), ("cp",), None, {}),
}


def base_inputs(seed: int):
    """float32 q, k, v and dO of the baseline cases, natural order."""
    q, k, v = qkv(np.random.default_rng(seed), BASE_SEQ, BASE_SEQ, BASE_HQ, BASE_HK, BASE_D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def dispatch_perm(dispatch) -> np.ndarray:
    """The natural rows of the dispatched layout (``ring_dispatch``'s)."""
    if dispatch is None or dispatch[1] == "contig":
        return np.arange(BASE_SEQ)
    from magiattention_tpu_torch.parallel._utils import zigzag_perm

    return zigzag_perm(BASE_SEQ, dispatch[0])


def port_mesh(spec, cache: dict):
    """The port's mesh of a case's spec over the world, made once."""
    from magiattention_tpu_torch.parallel import ProcessMesh, make_loongtrain_mesh

    key = repr(spec)
    if key not in cache:
        if spec[0] == "loongtrain":
            (u, o, i), placement = spec[1], spec[2]
            cache[key] = make_loongtrain_mesh(None, u, o, i, placement)
        else:
            names, shape = spec
            cache[key] = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)
    return cache[key]


def baselines_worker(rank: int, world: int, init_file: str, out_dir: str, cases: list) -> None:
    """One rank of the gloo group: each (baseline, mask) case through the
    port's function on this process's shard, forward and the backward of
    ``sum(out * dO)``; its shard index, out, lse, dq, dk, dv to
    ``out_dir/<baseline>_<mask>_<rank>.npz``. Then the collectives'
    adjoint checks over two subgroups to ``out_dir/adjoint_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import parallel

    meshes: dict = {}
    try:
        for name, mask in cases:
            fn, spec, axes, dispatch, kw = BASELINES[name]
            mesh = port_mesh(spec, meshes)
            perm = torch.from_numpy(dispatch_perm(dispatch))
            q, k, v, do = (
                parallel.local_shard(torch.from_numpy(a)[perm], mesh, axes)
                for a in base_inputs(len(mask))
            )
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out, lse = getattr(parallel, fn)(*leaves, *BASE_MASKS[mask], mesh, **kw)
            (out * do).sum().backward()
            np.savez(
                os.path.join(out_dir, f"{name}_{mask}_{rank}.npz"), index=mesh.index(axes),
                out=out.detach().numpy(), lse=lse.numpy(), dq=leaves[0].grad.numpy(),
                dk=leaves[1].grad.numpy(), dv=leaves[2].grad.numpy(),
            )
        np.savez(os.path.join(out_dir, f"adjoint_{rank}.npz"), **adjoint_checks(rank))
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


def adjoint_checks(rank: int) -> dict:
    """<op(x), y> and <x, op^T(y)> of every collective of
    ``comm.functional`` (op^T by autograd: the grad of <op(x), y> in x),
    each summed over the world, on a (2, 2) mesh: over the fast axis
    (subgroups {0, 1}, {2, 3}) and the slow one ({0, 2}, {1, 3})."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch.comm import functional as F
    from magiattention_tpu_torch.parallel import ProcessMesh

    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("a", "b"))
    rng = np.random.default_rng(100 + rank)
    res = {}

    def pair(name, op, x):
        xg = torch.from_numpy(x).requires_grad_(True)
        y_shape = op(xg.detach())
        y = torch.from_numpy(rng.standard_normal(tuple(y_shape.shape)).astype(np.float64))
        fwd = (op(xg) * y).sum()
        fwd.backward()
        both = torch.stack([fwd.detach(), (xg * xg.grad).sum().detach()])
        dist.all_reduce(both)
        res[name] = both.numpy()

    for axis in ("a", "b"):
        g, line, c = mesh.group(axis), mesh.line(axis), mesh.coord(axis)
        x = rng.standard_normal((8, 4, 3))
        pair(f"a2a_10_{axis}", lambda t: F.all_to_all(t, g, 1, 0), x)
        pair(f"a2a_01_{axis}", lambda t: F.all_to_all(t, g, 0, 1), x)
        pair(f"gather_{axis}", lambda t: F.all_gather(t, g), x)

        def ring(t, g=g, line=line, c=c):
            bufs, waits = F.ring_pass((t, 2 * t), F.ring_hops(2, line, c, g))
            for w in waits[1:]:
                w()
            return torch.cat([b for bs in bufs for b in bs])

        pair(f"ring_{axis}", ring, x)

    def double_ring(t):  # LoongTrain's double ring on the (2, 2) mesh
        from magiattention_tpu_torch.parallel.loongtrain import double_ring_hops

        (bufs,), waits = F.ring_pass((t,), double_ring_hops(mesh, "a", "b"))
        for w in waits[1:]:
            w()
        return torch.cat(bufs)

    pair("double_ring", double_ring, rng.standard_normal((8, 4, 3)))
    return res


# usp_nsa_attn (tests/test_torch_usp_nsa.py): the JAX package's
# tests/test_parallel/test_nsa.py shapes on a (ring 2, ulysses 2) mesh
NSA_SEQ, NSA_HQ, NSA_HK, NSA_D = 256, 4, 2, 32
NSA_CU = [0, 128, 256]
NSA_KW = dict(l_cmp=16, l_slc=32, d_stride=16, block_size_q=16, slc_top_k=2, window=(32, 0),
              causal=True)


def nsa_inputs(seed: int = 0):
    """float32 q, k, v and dO of the usp_nsa case, natural order."""
    q, k, v = qkv(np.random.default_rng(seed), NSA_SEQ, NSA_SEQ, NSA_HQ, NSA_HK, NSA_D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def usp_nsa_worker(rank: int, world: int, init_file: str, out_dir: str, tree: dict) -> None:
    """One rank of the gloo group: ``usp_nsa_attn`` on a (rp 2, sp 2)
    mesh over the JAX parameters ``tree`` (numpy), forward and the
    backward of ``sum(out * dO)``, the parameter gradients all-reduced
    (SUM) over the world; shard index, out and every gradient to
    ``out_dir/usp_nsa_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch.parallel import ProcessMesh, local_shard, params_from_numpy, usp_nsa_attn

    try:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("rp", "sp"))
        axes = ("rp", "sp")
        q, k, v, do = (local_shard(torch.from_numpy(a), mesh, axes) for a in nsa_inputs())
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        params = {n: p.requires_grad_(True) for n, p in params_from_numpy(tree, "cpu").items()}
        out = usp_nsa_attn(*leaves, params, NSA_CU, mesh, **NSA_KW)
        (out * do).sum().backward()
        grads = {f"g_{n}": p.grad for n, p in params.items()}
        for g in grads.values():
            dist.all_reduce(g)
        np.savez(
            os.path.join(out_dir, f"usp_nsa_{rank}.npz"), index=mesh.index(axes),
            out=out.detach().numpy(), dq=leaves[0].grad.numpy(), dk=leaves[1].grad.numpy(),
            dv=leaves[2].grad.numpy(), **{n: g.numpy() for n, g in grads.items()},
        )
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# two-level comm (tests/test_torch_hier.py): the JAX package's
# tests/test_comm/test_hier_pipeline.py shapes on a (dcn 2, ici 2) mesh
# ---------------------------------------------------------------------------

HIER_SEQ, HIER_HQ, HIER_HK, HIER_D, HIER_CHUNK = 256, 2, 1, 32, 16
HIER_MASKS = {
    "causal": ([[0, HIER_SEQ]], [[0, HIER_SEQ]], [1]),
    "shared_prefix": ([[0, 128], [128, HIER_SEQ], [128, HIER_SEQ]],
                      [[0, 128], [0, 128], [128, HIER_SEQ]], [0, 0, 1]),
}
HIER_FLAG = {"MAGI_ATTENTION_HIERARCHICAL_COMM": "1"}
HP_FLAG = {"MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": "1"}


def hier_inputs(seed: int = 11):
    """float32 q, k, v and dO of the two-level cases, natural order."""
    q, k, v = qkv(np.random.default_rng(seed), HIER_SEQ, HIER_SEQ, HIER_HQ, HIER_HK, HIER_D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


class _env:
    """Set flags for a block, then unset them."""

    def __init__(self, env: dict) -> None:
        self.env = env

    def __enter__(self):
        import os

        os.environ.update(self.env)

    def __exit__(self, *exc):
        import os

        for k in self.env:
            os.environ.pop(k, None)


def _api_fwd_bwd(key, arrays, heads=slice(None), kv_heads=slice(None), max_logits=False):
    """``dispatch -> calc_attn -> undispatch`` of the natural-order numpy
    ``arrays`` (q, k, v, dO; the heads given) and the backward of
    ``sum(out * dO)``: out, this rank's lse, dq, dk, dv (natural order,
    every rank's the whole gradients) and max-logits or None."""
    import torch

    from magiattention_tpu_torch import api

    q, k, v, do = arrays
    leaves = [torch.from_numpy(np.ascontiguousarray(a[:, h])).requires_grad_(True)
              for a, h in ((q, heads), (k, kv_heads), (v, kv_heads))]
    out_d, meta = api.calc_attn(
        api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
        api.dispatch(leaves[2], key, role="kv"), key, return_max_logits=max_logits,
    )
    out = api.undispatch(out_d, key)
    (out * torch.from_numpy(np.ascontiguousarray(do[:, heads]))).sum().backward()
    ml = meta.max_logits.numpy() if max_logits else None
    return [out.detach().numpy(), meta.lse.numpy(), *(t.grad.numpy() for t in leaves)], ml


def _recording_all_to_all(log: list):
    """``dist.all_to_all_single`` that logs each call's input dtype."""
    import torch.distributed as dist

    a2a = dist.all_to_all_single

    def rec(out, inp, *args, **kwargs):
        log.append(str(inp.dtype))
        return a2a(out, inp, *args, **kwargs)

    return a2a, rec


def hier_worker(rank: int, world: int, init_file: str, out_dir: str, masks: list) -> None:
    """One rank of a (dcn 2, ici 2) gloo world: for each mask, the API over
    ``mesh, cp_axis=("dcn", "ici")`` flat (flag unset), two-level
    (MAGI_ATTENTION_HIERARCHICAL_COMM=1) and two-level under the
    high-precision reduce, forward and backward; then each stage's cast on
    its own, two-level against flat (float32, and bf16 under hp with the
    wire dtypes logged), forward buffers and the backward's gradients; the
    plan cache's entries; qo-comm refused. Results to
    ``out_dir/<case>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.comm.primitives import group_cast_all
    from magiattention_tpu_torch.parallel import ProcessMesh

    try:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("dcn", "ici"))
        pair = ("dcn", "ici")

        def key_of(mask, **kw):
            qr, kr, tm = HIER_MASKS[mask]
            return api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, device="cpu",
                                          chunk_size=HIER_CHUNK, **kw)

        arrays = hier_inputs()
        for mask in masks:
            res = {}
            key_f = key_of(mask, mesh=mesh, cp_axis=pair)
            res["flat"], _ = _api_fwd_bwd(key_f, arrays)
            with _env(HIER_FLAG):
                key_h = key_of(mask, mesh=mesh, cp_axis=pair)
                res["hier"], _ = _api_fwd_bwd(key_h, arrays)
                with _env(HP_FLAG):
                    res["hier_hp"], _ = _api_fwd_bwd(key_of(mask, mesh=mesh, cp_axis=pair), arrays)
            rt_f, rt_h = _mgr(key_f).runtime, _mgr(key_h).runtime
            stages = _mgr(key_h).comm_meta.kv_stages
            extra = dict(
                hier_runtime=rt_h.hier, flat_runtime=rt_f.hier,
                dcn_rows=np.asarray([s.telemetry_dict()["dcn_rows"] for s in stages]),
                flat_dcn_rows=np.asarray([
                    sum(s.transfer_table[d][src].total_seqlen for d in range(4) for src in range(4)
                        if d // 2 != src // 2) for s in stages]),
            )
            # each stage's cast alone: float32, then bf16 under hp
            rng = np.random.default_rng(100 + rank)
            shard = rt_h.calc_meta.kv_shard_len
            for st, (p_f, p_h) in enumerate(zip(rt_f.cast_plans, rt_h.cast_plans)):
                x = torch.from_numpy(rng.standard_normal((shard, 3)).astype(np.float32))
                y = torch.from_numpy(rng.standard_normal((p_f.buf_len, 3)).astype(np.float32))
                for name, plan, group in (("f", p_f, rt_f.cast_group), ("h", p_h, rt_h.cast_group)):
                    for dt, hp in ((torch.float32, False), (torch.bfloat16, True)):
                        xg = x.to(dt).clone().requires_grad_(True)
                        log: list = []
                        a2a, rec = _recording_all_to_all(log)
                        dist.all_to_all_single = rec
                        try:
                            parts, waits = group_cast_all(xg, [plan], group, hp)
                            waits[0]()
                            fwd_log = list(log)
                            (parts[1] * y).sum().backward()
                        finally:
                            dist.all_to_all_single = a2a
                        tag = f"{name}{st}_{'hp' if hp else 'f32'}"
                        extra[f"buf_{tag}"] = parts[1].detach().float().numpy()
                        extra[f"grad_{tag}"] = xg.grad.float().numpy()
                        extra[f"fwd_wire_{tag}"] = np.asarray(fwd_log)
                        extra[f"bwd_wire_{tag}"] = np.asarray(log[len(fwd_log):])
            np.savez(os.path.join(out_dir, f"{mask}_{rank}.npz"),
                     **{f"{k}_{n}": a for k, v in res.items()
                        for n, a in zip(("out", "lse", "dq", "dk", "dv"), v)}, **extra)
        # the plan cache: a two-level key and a flat key of the same cp
        # group and mask under the flag never share a plan
        mask = masks[0]
        with _env(HIER_FLAG):
            api.clear_cache()
            mgrs = [_mgr(key_of(mask, mesh=mesh, cp_axis=pair))]
            mgrs.append(_mgr(key_of(mask, cp_group=mesh.group(pair))))
            api.clear_cache()
            mgrs.append(_mgr(key_of(mask, mesh=mesh, cp_axis=pair)))
        cache = dict(
            sources=np.asarray([m.plan_source for m in mgrs]),
            hier_plans=np.asarray([all(s.hier_plan is not None for s in m.comm_meta.kv_stages)
                                   for m in mgrs]),
            runtimes=np.asarray([m.runtime.hier for m in mgrs]),
            same_metas=mgrs[0].comm_meta is mgrs[2].comm_meta,
        )
        with _env({**HIER_FLAG, "MAGI_ATTENTION_QO_COMM": "1"}):
            try:
                key_of(mask, mesh=mesh, cp_axis=pair)
                cache["qo_refusal"] = ""
            except NotImplementedError as e:
                cache["qo_refusal"] = str(e)
        np.savez(os.path.join(out_dir, f"cache_{rank}.npz"), **cache)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# TP x CP (tests/test_torch_tp_cp.py): the JAX package's
# tests/test_parallel/test_tp_cp.py widths on a (cp 2, tp 2) mesh
# ---------------------------------------------------------------------------

TP_SEQ, TP_HQ, TP_HK, TP_D, TP_CHUNK = 256, 4, 2, 32, 16
TP_MASKS = {
    "causal": ([[0, TP_SEQ]], [[0, TP_SEQ]], [1]),
    "shared_prefix": ([[0, 128], [128, TP_SEQ], [128, TP_SEQ]],
                      [[0, 128], [0, 128], [128, TP_SEQ]], [0, 0, 1]),
}


def tp_inputs(seed: int = 0, hk: int = TP_HK):
    """float32 q, k, v and dO of the TP x CP cases, natural order."""
    q, k, v = qkv(np.random.default_rng(seed), TP_SEQ, TP_SEQ, TP_HQ, hk, TP_D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def tp_heads(t: int, tp: int, n: int) -> slice:
    """TP rank t's heads of n, as Megatron splits them."""
    return slice(t * n // tp, (t + 1) * n // tp)


def tp_worker(rank: int, world: int, init_file: str, out_dir: str, masks: list) -> None:
    """One rank of a (cp 2, tp 2) gloo world: for each mask, the API with
    ``mesh, cp_axis="cp", head_axis="tp"`` on this rank's heads (q heads
    ``hq / 2``, kv heads ``hk / 2``), forward with max-logits and backward;
    the solves this process ran (a key without ``head_axis`` must reuse the
    plan); then kv heads that do not split over TP, and ``head_axis`` under
    qo-comm. Results to ``out_dir/<case>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api, dist_attn_runtime_mgr
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.parallel import ProcessMesh

    solves = []
    solve = dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta

    def counted(*args, **kwargs):
        solves.append(1)
        return solve(*args, **kwargs)

    dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta = counted
    try:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("cp", "tp"))
        t = mesh.coord("tp")
        heads, kv_heads = tp_heads(t, 2, TP_HQ), tp_heads(t, 2, TP_HK)

        def key_of(mask, **kw):
            qr, kr, tm = TP_MASKS[mask]
            return api.magi_attn_flex_key(qr, kr, tm, TP_SEQ, TP_SEQ, mesh=mesh, cp_axis="cp",
                                          device="cpu", chunk_size=TP_CHUNK, **kw)

        for mask in masks:
            before = len(solves)
            key = key_of(mask, head_axis="tp")
            got, ml = _api_fwd_bwd(key, tp_inputs(), heads, kv_heads, max_logits=True)
            plain = _mgr(key_of(mask))  # the same cp line without head_axis
            np.savez(
                os.path.join(out_dir, f"{mask}_{rank}.npz"), tp=t, cp=mesh.coord("cp"), ml=ml,
                **dict(zip(("out", "lse", "dq", "dk", "dv"), got)),
                solves=len(solves) - before, reuse=plain.plan_source,
                send_idx=np.concatenate([s.send_idx.ravel() for s in plain.comm_meta.kv_stages]),
            )
        res = {}
        api.clear_cache()  # a new runtime checks the heads at its first call
        key = key_of(masks[0], head_axis="tp")
        try:  # three kv heads: 2 on tp rank 0, 1 on tp rank 1
            _api_fwd_bwd(key, tp_inputs(hk=3), heads, tp_heads(t, 2, 3))
            res["uneven"] = ""
        except ValueError as e:
            res["uneven"] = str(e)
        with _env({"MAGI_ATTENTION_QO_COMM": "1"}):
            try:
                key_of(masks[0], head_axis="tp")
                res["qo"] = ""
            except NotImplementedError as e:
                res["qo"] = str(e)
        np.savez(os.path.join(out_dir, f"raises_{rank}.npz"), **res)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta = solve
        dist.destroy_process_group()


def tile_cp_worker(rank: int, world: int, init_file: str, out_dir: str, cases: list) -> None:
    """One rank of the gloo group for the auto-tile cross-check
    (tests/test_torch_ffa_mixed.py): every case (name, q/k ranges, types,
    overlap degree, seed, env) through key -> dispatch -> calc_attn ->
    undispatch under its env, forward and backward, with the runtime's
    tiles: its plans' (bq, bk), the policy's per-pass picks and what the
    policy picks over every rank's slice set; to ``out_dir/<name>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig
    from magiattention_tpu_torch.kernels.tile_policy import choose_blocks_per_pass_multi

    try:
        for name, qr, kr, types, degree, seed, env in cases:
            os.environ.update(env)
            config = DistAttnConfig(overlap_config=OverlapConfig(degree=degree, min_chunk_size=32))
            key = api.magi_attn_flex_key(
                qr, kr, types, CP_SEQ, CP_SEQ, cp_group=dist.group.WORLD, device="cpu",
                chunk_size=CP_CHUNK, dist_attn_config=config,
            )
            q, k, v, do = (torch.from_numpy(a) for a in cp_inputs(seed))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out_d, meta = api.calc_attn(
                api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
                api.dispatch(leaves[2], key, role="kv"), key,
            )
            out = api.undispatch(out_d, key)
            (out * do).sum().backward()
            rt = _mgr(key).runtime
            geoms, sq, sk = rt._tile_geoms()
            pick = choose_blocks_per_pass_multi(geoms, sq, sk, CP_D, CP_D, 4)
            none = (0, 0)
            np.savez(
                os.path.join(out_dir, f"{name}_{rank}.npz"),
                out=out.detach().numpy(), lse=meta.lse.numpy(), dq=leaves[0].grad.numpy(),
                dk=leaves[1].grad.numpy(), dv=leaves[2].grad.numpy(),
                pending=rt._auto_tile_pending,
                plan_tiles=np.array([(p.block_q, p.block_k) for p in rt.plans]),
                policy_bwd=np.array([t or none for t in rt._policy_bwd]),
                pick=np.array([pick[0], pick[1] or none, pick[2] or none]),
                params_dq=np.array([p.dq_blocks() for p in rt._params(CP_D, 4)]),
                params_dkv=np.array([p.dkv_blocks() for p in rt._params(CP_D, 4)]),
            )
            for key_ in env:
                os.environ.pop(key_)
        dist.barrier()
    finally:
        dist.destroy_process_group()
