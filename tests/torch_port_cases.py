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
        # the same step with each layer recomputed in the backward: every
        # rank issues the recompute's GroupCasts in the same order
        loss_r, grads_r = llama.value_and_grad(
            params, llama.LlamaConfig(**LLAMA_CP_CFG, remat=True), tokens, labels, key)
        np.savez(os.path.join(out_dir, f"llama_{rank}.npz"), loss=loss.numpy(),
                 all_reduce_calls=len(calls), loss_remat=loss_r.numpy(),
                 **{f"g{i}": g.numpy() for i, g in enumerate(grads)},
                 **{f"remat_g{i}": g.numpy() for i, g in enumerate(grads_r)})
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


# ---------------------------------------------------------------------------
# the staged (overlapped) backward (tests/test_torch_overlap.py): the JAX
# package's tests/test_support/test_template_mla.py widths at cp 4
# ---------------------------------------------------------------------------

OVERLAP_DEGREE = 2
OVERLAP_NAMES = ("out", "lse", "dq", "dk", "dv")
PRECISION_BF16 = {"MAGI_ATTENTION_PRECISION": "bf16"}


def overlap_config(pkg):
    """The overlap config of the staged cases (degree 2, chunks of 16), of
    the port (``pkg`` its ``config`` module) or of the JAX package."""
    return pkg.DistAttnConfig(
        overlap_config=pkg.OverlapConfig(degree=OVERLAP_DEGREE, min_chunk_size=HIER_CHUNK)
    )


def _runtime_fwd_bwd(rt, arrays, dist_attn_func=None):
    """(out, lse, dq, dk, dv) of this rank's dispatched numpy ``arrays``
    (q, k, v, dO rows) through ``rt.calc_attn`` (or ``dist_attn_func``
    over ``rt``), the backward of ``sum(out * dO)``."""
    import torch

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    if dist_attn_func is None:
        out, lse = rt.calc_attn(*leaves)
    else:
        out, lse = dist_attn_func(*leaves, rt)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(arrays[3]).to(out.dtype))
    return [t.detach().float().numpy() for t in (out, lse, *grads)]


class _SkippedWait:
    """A stage's cast whose receive buffer is read as it was before the
    rows landed (zeros): the transfer runs to its end, into another
    buffer, and the wait the runtime calls does nothing."""

    def __init__(self, plan) -> None:
        self.plan = plan

    def __getattr__(self, name):
        return getattr(self.plan, name)

    def cast_start(self, x, group, out_dtype):
        buf, wait = self.plan.cast_start(x, group, out_dtype)
        wait()
        return buf.new_zeros(buf.shape), lambda: None


def overlap_worker(rank: int, world: int, init_file: str, out_dir: str, masks: list) -> None:
    """One rank of a gloo world of 4: for each mask, the runtime of a
    degree-2 plan run with the staged backward and with every reduce after
    every part's backward (``staged_backward=False``), flat and two-level
    at (dcn 2, ici 2), each with and without the high-precision reduce;
    ``dist_attn_func`` with MAGI_ATTENTION_PRECISION unset and bf16;
    ``assert_overlap_safe`` on the plan and with one stage's wait skipped;
    ``get_mesh`` of a mesh key and of a ``cp_group`` key. Results (this
    rank's dispatched rows) to ``out_dir/<mask>_<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api, config
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.functional.dist_attn import dist_attn_func
    from magiattention_tpu_torch.parallel import ProcessMesh
    from magiattention_tpu_torch.testing import template

    try:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("dcn", "ici"))
        pair = ("dcn", "ici")
        for mask in masks:
            qr, kr, tm = HIER_MASKS[mask]

            def key_of(**kw):
                return api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, device="cpu",
                                              chunk_size=HIER_CHUNK,
                                              dist_attn_config=overlap_config(config), **kw)

            key_f = key_of(cp_group=dist.group.WORLD)
            with _env(HIER_FLAG):
                key_h = key_of(mesh=mesh, cp_axis=pair)
            arrays = [api.dispatch(torch.from_numpy(a), key_f, role=role).numpy()
                      for a, role in zip(hier_inputs(), ("qo", "kv", "kv", "qo"))]
            res = {}
            for comm, key in (("flat", key_f), ("hier", key_h)):
                rt = _mgr(key).runtime
                assert rt.use_overlap and rt.num_stages == OVERLAP_DEGREE and rt.hier == (comm == "hier")
                for hp, env in (("", {}), ("_hp", HP_FLAG)):
                    with _env(env):
                        for staged in (True, False):
                            rt.staged_backward = staged
                            got = _runtime_fwd_bwd(rt, arrays)
                            tag = f"{comm}{hp}_{'staged' if staged else 'unstaged'}"
                            res.update({f"{tag}_{n}": a for n, a in zip(OVERLAP_NAMES, got)})
                rt.staged_backward = True
            rt = _mgr(key_f).runtime
            for tag, env in (("func", {}), ("func_bf16", PRECISION_BF16)):
                with _env(env):
                    got = _runtime_fwd_bwd(rt, arrays, dist_attn_func)
                res.update({f"{tag}_{n}": a for n, a in zip(OVERLAP_NAMES, got)})
            # the overlap-safety check: on the plan, then with the last
            # stage's wait skipped in the overlapped runtime alone
            mgr = _mgr(key_f)
            q, k, v, do = (torch.from_numpy(a) for a in arrays)
            template.assert_overlap_safe(mgr.comm_meta, mgr.calc_meta, dist.group.WORLD, q, k, v,
                                         do=do)
            real = template.DistAttnRuntime

            def skipping(*args, use_overlap=None, **kw):
                runtime = real(*args, use_overlap=use_overlap, **kw)
                if use_overlap:
                    runtime.cast_plans[-1] = _SkippedWait(runtime.cast_plans[-1])
                return runtime

            template.DistAttnRuntime = skipping
            try:
                template.assert_overlap_safe(mgr.comm_meta, mgr.calc_meta, dist.group.WORLD,
                                             q, k, v, do=do, iters=1)
                res["skipped_wait_error"] = ""
            except AssertionError as e:
                res["skipped_wait_error"] = str(e)
            finally:
                template.DistAttnRuntime = real
            # get_mesh: a mesh key's own mesh; a one-axis mesh over a
            # cp_group key's group
            m_h, m_f = api.get_mesh(key_h), api.get_mesh(key_f)
            res.update(
                mesh_is_keys=m_h is mesh, group_mesh_shape=np.asarray(m_f.shape["cp"]),
                group_mesh_line=np.asarray(m_f.line("cp")), group_mesh_coord=m_f.coord("cp"),
                group_mesh_group=m_f.group("cp") is dist.group.WORLD,
                group_mesh_cached=api.get_mesh(key_f) is m_f,
            )
            np.savez(os.path.join(out_dir, f"{mask}_{rank}.npz"), **res)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# the MoE family (tests/test_torch_moe.py): the JAX package's
# tests/test_models/test_moe.py shapes, two causal documents, chunk 16
MOE_CFG = dict(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, ffn_hidden=96, dtype="float32", n_experts=8, top_k=2,
)
MOE_SEQ, MOE_CHUNK, MOE_LR, MOE_STEPS = 128, 16, 1e-2, 3
MOE_CFS = (8.0, 1.25)  # ample capacity (no drop), the default


def moe_data():
    """Tokens, next-token labels (-1 at the end), and the FFN input h."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, MOE_CFG["vocab_size"], MOE_SEQ).astype(np.int32)
    labels = np.concatenate([tokens[1:], [-1]]).astype(np.int32)
    h = np.random.default_rng(1).standard_normal((MOE_SEQ, MOE_CFG["dim"])).astype(np.float32)
    return tokens, labels, h


def moe_worker(rank: int, world: int, init_file: str, out_dir: str, tree: dict) -> None:
    """One rank of a gloo world of 4 over the JAX MoE parameters ``tree``
    (numpy): the MoE FFN expert-parallel at ep 2 (the ``ep`` lines of a
    (dp 2, ep 2) mesh) and ep 4 (output, aux, the layer's gradients of
    ``sum(y * y) + aux``), then the full model at cp 4 with
    ``ep_axis="cp"`` at each of ``MOE_CFS`` (undispatched logits, aux,
    loss, gradients; with remat; the all_reduce count), loss and
    gradients under one causal document at overlap degree 1 and 2 (the
    staged runtime), three SGD steps (the EP trees from
    ``shard_moe_params``: gradients and parameters saved gathered),
    the model without EP, and the divisibility error; all to
    ``out_dir/moe_<rank>.npz``."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models import moe
    from magiattention_tpu_torch.models.shard import gather_leaves, gather_params
    from magiattention_tpu_torch.parallel import ProcessMesh

    s = MOE_SEQ
    res = {}
    try:
        cfg = moe.MoEConfig(**MOE_CFG)
        params = moe.moe_params_from_numpy(tree, "cpu")
        lyr = params["layers"][0]
        tokens, labels, h = (torch.from_numpy(a) for a in moe_data())
        # the FFN at ep 2: each ep line of the (dp, ep) mesh routes h
        mesh2 = ProcessMesh(np.arange(4).reshape(2, 2), ("dp", "ep"))
        c = mesh2.coord("ep")
        y, aux = moe.moe_ffn(h[c * s // 2:(c + 1) * s // 2], lyr, cfg, mesh=mesh2, ep_axis="ep")
        res.update(ep2_y=y.numpy(), ep2_aux=aux.numpy())
        # ep 4, the expert stacks as this rank's block; the gradients of
        # JAX's sum(y * y) + aux: this rank's share sum(y_r * y_r) + aux / 4
        mesh4 = ProcessMesh(np.arange(4), ("ep",))
        n = cfg.n_experts // 4
        block = {**lyr, **{k: lyr[k][rank * n:(rank + 1) * n].clone()
                           for k in ("w_gate", "w_up", "w_down")}}
        live = {k: v.detach().requires_grad_(True) for k, v in block.items()}
        y, aux = moe.moe_ffn(h[rank * s // 4:(rank + 1) * s // 4], live, cfg, mesh=mesh4,
                             ep_axis="ep")
        keys = ("router", "w_gate", "w_up", "w_down")
        grads = torch.autograd.grad((y * y).sum() + aux / 4, [live[k] for k in keys])
        dist.all_reduce(grads[0])  # the replicated router's shares
        res.update(ep4_y=y.detach().numpy(), ep4_aux=aux.detach().numpy(),
                   **{f"ep4_g_{k}": g.numpy() for k, g in zip(keys, grads)})
        # the full model at cp 4, EP over the cp axis
        key = api.magi_attn_flex_key([[0, s // 2], [s // 2, s]], [[0, s // 2], [s // 2, s]], [1, 1],
                                     s, s, cp_group=dist.group.WORLD, device="cpu",
                                     chunk_size=MOE_CHUNK)
        sharded = moe.shard_moe_params(params, api.get_mesh(key), ep_axis="cp")

        def whole(grads):  # the sharded tree's gradients, gathered
            return gather_leaves(grads, sharded, moe.LAYOUT)

        calls, all_reduce = [], dist.all_reduce

        def counted(*args, **kwargs):
            calls.append(1)
            return all_reduce(*args, **kwargs)

        for i, cf in enumerate(MOE_CFS):
            c_cf = dataclasses.replace(cfg, capacity_factor=cf)
            logits, aux = moe.moe_forward(sharded, c_cf, tokens, key, ep_axis="cp")
            res.update({f"cf{i}_logits": api.undispatch(logits, key).numpy(),
                        f"cf{i}_aux": aux.numpy()})
            dist.all_reduce = counted
            try:
                loss, grads = moe.moe_value_and_grad(sharded, c_cf, tokens, labels, key, "cp")
            finally:
                dist.all_reduce = all_reduce
            res.update({f"cf{i}_loss": loss.numpy(), f"cf{i}_all_reduce_calls": len(calls)})
            res.update({f"cf{i}_g{j}": g.numpy() for j, g in enumerate(whole(grads))})
            calls.clear()
            c_r = dataclasses.replace(c_cf, remat=True)
            logits_r, _ = moe.moe_forward(sharded, c_r, tokens, key, ep_axis="cp")
            loss_r, grads_r = moe.moe_value_and_grad(sharded, c_r, tokens, labels, key, "cp")
            res.update({f"cf{i}_remat_logits": api.undispatch(logits_r, key).numpy(),
                        f"cf{i}_remat_loss": loss_r.numpy()})
            res.update({f"cf{i}_remat_g{j}": g.numpy() for j, g in enumerate(whole(grads_r))})
        # one causal document at overlap degree 1 and 2 (two stages): the
        # staged GroupCasts and GroupReduces and the MoE exchanges share
        # the group, issued in one order on every rank
        from magiattention_tpu_torch import config
        from magiattention_tpu_torch.api.magi_attn_interface import _mgr

        for degree, cfg_o in ((1, None), (2, overlap_config(config))):
            key_o = api.magi_attn_flex_key([[0, s]], [[0, s]], [1], s, s,
                                           cp_group=dist.group.WORLD, device="cpu",
                                           chunk_size=MOE_CHUNK, dist_attn_config=cfg_o)
            rt = _mgr(key_o).runtime
            res[f"degree{degree}_stages"] = rt.num_stages if rt.use_overlap else 1
            loss, grads = moe.moe_value_and_grad(sharded, cfg, tokens, labels, key_o, "cp")
            res[f"degree{degree}_loss"] = loss.numpy()
            res.update({f"degree{degree}_g{j}": g.numpy() for j, g in enumerate(whole(grads))})
        # three SGD steps at the default capacity
        steps = moe.shard_moe_params(moe.moe_params_from_numpy(tree, "cpu"), api.get_mesh(key),
                                     ep_axis="cp")  # updated in place
        losses = []
        for _ in range(MOE_STEPS):
            steps, loss = moe.moe_train_step(steps, cfg, tokens, labels, key, "cp", lr=MOE_LR)
            losses.append(loss.item())
        res["train_losses"] = np.asarray(losses)
        res.update({f"train_p{j}": p.numpy() for j, p in enumerate(moe.LAYOUT.leaves(
            gather_params(steps)))})
        # without EP: every rank routes the gathered rows on the full stacks
        loss, grads = moe.moe_value_and_grad(params, cfg, tokens, labels, key)
        res["noep_loss"] = loss.numpy()
        res.update({f"noep_g{j}": g.numpy() for j, g in enumerate(grads)})
        try:
            bad = {"layers": [{k: torch.zeros((6, 1, 1)) for k in ("w_gate", "w_up", "w_down")}]}
            moe.shard_moe_params(bad, api.get_mesh(key), ep_axis="cp")
            res["divisibility_error"] = ""
        except ValueError as e:
            res["divisibility_error"] = str(e)
        np.savez(os.path.join(out_dir, f"moe_{rank}.npz"), **res)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# the video DiT (tests/test_torch_video_dit.py): the JAX package's
# tests/test_models/test_video_dit.py config
DIT_CFG = dict(
    num_frames=4, tokens_per_frame=64, in_dim=8, dim=64, n_layers=2, n_heads=2,
    n_kv_heads=1, head_dim=32, ffn_hidden=128, window_frames=2, dtype="float32",
)
DIT_T = 0.3


def dit_data():
    """Clean latents and noise, natural order (JAX's test's draws)."""
    rng = np.random.default_rng(1)
    n = DIT_CFG["num_frames"] * DIT_CFG["tokens_per_frame"]
    clean = rng.standard_normal((n, DIT_CFG["in_dim"])).astype(np.float32)
    noise = rng.standard_normal((n, DIT_CFG["in_dim"])).astype(np.float32)
    return clean, noise


def dit_worker(rank: int, world: int, init_file: str, out_dir: str, tree: dict) -> None:
    """One rank of a gloo world: the port's DiT ``value_and_grad`` at cp =
    world over the JAX parameters ``tree`` (numpy), with and without
    remat; loss and gradients to ``out_dir/dit_<rank>.npz``."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch.models import video_dit

    try:
        cfg = video_dit.VideoDiTConfig(**DIT_CFG)
        key = video_dit.make_video_attn_key(cfg, cp_group=dist.group.WORLD, device="cpu")
        params = video_dit.params_from_numpy(tree, "cpu")
        clean, noise = (torch.from_numpy(a) for a in dit_data())
        res = {}
        for tag, c in (("", cfg), ("remat_", dataclasses.replace(cfg, remat=True))):
            loss, grads = video_dit.value_and_grad(params, c, clean, noise, DIT_T, key)
            res[f"{tag}loss"] = loss.numpy()
            res.update({f"{tag}g{i}": g.numpy() for i, g in enumerate(grads)})
        np.savez(os.path.join(out_dir, f"dit_{rank}.npz"), **res)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# sharded trees (tests/test_torch_shard.py): ZeRO-3 and Megatron TP over
# one gloo world of 4, the families at their JAX tests' shapes
# ---------------------------------------------------------------------------

SHARD_LR, SHARD_STEPS = 1e-2, 3
ADAMW = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
# name -> (family, mesh axes, shard kwargs, key kwargs, ep_axis)
SHARD_CASES = {
    "llama_z3": ("llama", ("cp",), {}, {}, None),
    "llama_tp": ("llama", ("cp", "tp"), {"tp_axis": "tp"}, {"head_axis": "tp"}, None),
    "dit_z3": ("dit", ("cp",), {}, {}, None),
    "moe_noep": ("moe", ("cp",), {}, {}, None),
    "moe_ep4": ("moe", ("cp",), {"ep_axis": "cp"}, {}, "cp"),
    "moe_ep_tp": ("moe", ("cp", "tp"), {"ep_axis": "tp"}, {}, "tp"),
}


def shard_mesh_shape(axes) -> tuple[int, ...]:
    return (4,) if len(axes) == 1 else (2, 2)


def _counting(calls: list):
    """``dist.all_reduce`` wrapped to count its calls into ``calls``."""
    import torch.distributed as dist

    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    return real, counted


def shard_worker(rank: int, world: int, init_file: str, out_dir: str, trees: dict) -> None:
    """One rank of a gloo world of 4 over the JAX trees ``trees``
    (``{"llama", "moe", "dit"}``, numpy): for each case of
    ``SHARD_CASES`` the family's tree sharded on its mesh, its shards, the
    tree gathered back, ``SHARD_STEPS`` SGD steps (losses; the tree after
    steps 1 and 3, gathered; the collectives of step 2); for ``llama_z3``
    also the remat step and ``SHARD_STEPS`` AdamW steps; for
    ``llama_tp`` each rank's heads in ``calc_attn`` and the step under a
    key without ``head_axis``; the DiT at (cp 2, tp 2) under a
    ``head_axis`` key and under the video key; for ``moe_ep_tp`` the step
    with EP over the cp axis of the same mesh and on the whole tree. To ``out_dir/shard_<rank>.npz``."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.comm.functional import (
        collective_counts,
        reset_collective_counts,
    )
    from magiattention_tpu_torch.models import llama, moe, video_dit
    from magiattention_tpu_torch.models.shard import gather_leaves
    from magiattention_tpu_torch.parallel import ProcessMesh

    fam = {
        "llama": (llama.LlamaConfig(**LLAMA_CP_CFG), llama.LAYOUT, llama.shard_params),
        "moe": (moe.MoEConfig(**MOE_CFG), moe.LAYOUT, moe.shard_moe_params),
        "dit": (video_dit.VideoDiTConfig(**DIT_CFG), video_dit.LAYOUT, video_dit.shard_params),
    }
    tokens, labels = (torch.from_numpy(a) for a in llama_cp_data())
    m_tokens, m_labels, _ = (torch.from_numpy(a) for a in moe_data())
    clean, noise = (torch.from_numpy(a) for a in dit_data())
    s = LLAMA_CP_SEQ
    docs = [[0, s // 2], [s // 2, s]]
    res = {}
    meshes = {}

    def key_of(family, mesh, **kw):
        if family == "dit":
            cfg = fam["dit"][0]
            return video_dit.make_video_attn_key(cfg, mesh=mesh, device="cpu", **kw)
        return api.magi_attn_flex_key(docs, docs, [1, 1], s, s, mesh=mesh, cp_axis="cp",
                                      device="cpu", chunk_size=16, **kw)

    def step_fn(family, cfg, key, ep_axis):
        if family == "llama":
            return lambda p: llama.train_step(p, cfg, tokens, labels, key, lr=SHARD_LR)
        if family == "moe":
            return lambda p: moe.moe_train_step(p, cfg, m_tokens, m_labels, key, ep_axis,
                                                lr=SHARD_LR)
        step = video_dit.make_optim_train_step(cfg, key, torch.optim.SGD(
            video_dit.param_list(p_dit[0]), lr=SHARD_LR))
        return lambda p: step(p, clean, noise, DIT_T)

    def gathered(tag, params, layout):
        full = gather_leaves(layout.leaves(params), params, layout)
        res.update({f"{tag}p{j}": x.numpy() for j, x in enumerate(full)})

    p_dit = [None]
    try:
        for case, (family, axes, shard_kw, key_kw, ep_axis) in SHARD_CASES.items():
            cfg, layout, shard = fam[family]
            if axes not in meshes:
                meshes[axes] = ProcessMesh(np.arange(4).reshape(shard_mesh_shape(axes)), axes)
            mesh = meshes[axes]
            key = key_of(family, mesh, **key_kw)
            whole = layout.from_numpy(trees[family], "cpu")
            params = shard(whole, mesh, **shard_kw)
            p_dit[0] = params
            # the family's layout, each shard, and the whole tree back bitwise
            res[f"{case}_layout"] = [k for k in params if k != "sharding"] == list(whole)
            # copies: the steps below update the shards in place
            res.update({f"{case}_s{j}": x.numpy().copy()
                        for j, x in enumerate(layout.leaves(params))})
            back = llama.gather_params(params)
            res[f"{case}_roundtrip"] = all(
                torch.equal(a, b) for a, b in zip(layout.leaves(back), layout.leaves(whole)))
            step = step_fn(family, cfg, key, ep_axis)
            losses, calls = [], []
            for i in range(SHARD_STEPS):
                reset_collective_counts()
                real, counted = _counting(calls)
                if i == 1:
                    dist.all_reduce = counted
                try:
                    params, loss = step(params)
                finally:
                    dist.all_reduce = real
                losses.append(float(loss))
                if i == 1:
                    res.update({f"{case}_count_{k}": v for k, v in collective_counts().items()})
                    res[f"{case}_all_reduce_calls"] = len(calls)
                if i in (0, SHARD_STEPS - 1):
                    gathered(f"{case}_step{i + 1}_", params, layout)
            res[f"{case}_losses"] = np.asarray(losses)

        # llama at cp 4: remat, and AdamW
        cfg, layout, _ = fam["llama"]
        key = key_of("llama", meshes[("cp",)])
        whole = llama.params_from_numpy(trees["llama"], "cpu")
        params = llama.shard_params(whole, meshes[("cp",)])
        loss, grads = llama.value_and_grad(params, cfg, tokens, labels, key)
        loss_r, grads_r = llama.value_and_grad(params, dataclasses.replace(cfg, remat=True),
                                               tokens, labels, key)
        res["remat_loss_diff"] = abs(float(loss_r) - float(loss))
        res["remat_grad_diff"] = max(float((a - b).abs().max()) for a, b in zip(grads, grads_r))
        optim = torch.optim.AdamW(llama.param_list(params), lr=ADAMW["lr"],
                                  betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
                                  weight_decay=ADAMW["weight_decay"])
        step = llama.make_optim_train_step(cfg, key, optim)
        losses = []
        for i in range(SHARD_STEPS):
            params, loss = step(params, tokens, labels)
            losses.append(float(loss))
            if i in (0, SHARD_STEPS - 1):
                gathered(f"adamw_step{i + 1}_", params, layout)
        res["adamw_losses"] = np.asarray(losses)

        # llama at (cp 2, tp 2): each rank's heads, and the TP-sharded tree
        # under a key without head_axis (every leaf gathered, TP ranks alike)
        mesh = meshes[("cp", "tp")]
        heads, calc = [], llama.calc_attn

        def recording(q, k, v, attn_key):
            heads.append((q.shape[1], k.shape[1]))
            return calc(q, k, v, attn_key)

        tp_params = llama.shard_params(whole, mesh, tp_axis="tp")
        llama.calc_attn = recording
        try:
            _, g_tp = llama.value_and_grad(tp_params, cfg, tokens, labels,
                                           key_of("llama", mesh, head_axis="tp"))
            res["tp_heads"] = np.asarray(heads)
            heads.clear()
            loss_f, g_f = llama.value_and_grad(tp_params, cfg, tokens, labels,
                                               key_of("llama", mesh))
            res["tpfull_heads"] = np.asarray(heads)
        finally:
            llama.calc_attn = calc
        res["tpfull_loss"] = float(loss_f)
        for tag, g in (("tp_g", g_tp), ("tpfull_g", g_f)):
            res.update({f"{tag}{j}": x.numpy()
                        for j, x in enumerate(gather_leaves(g, tp_params, layout))})

        # the DiT at (cp 2, tp 2) (two kv heads, so that they split): the
        # TP-sharded tree under a head_axis key (Megatron) and under the
        # video key (every leaf gathered)
        cfg = dataclasses.replace(fam["dit"][0], n_kv_heads=2)
        whole = video_dit.init_params(cfg, seed=0, device="cpu")
        params = video_dit.shard_params(whole, mesh, tp_axis="tp")
        res["dit_tp_layout"] = [k for k in params if k != "sharding"] == list(whole)
        res["dit_tp_roundtrip"] = all(torch.equal(a, b) for a, b in zip(
            video_dit.param_list(llama.gather_params(params)), video_dit.param_list(whole)))
        qr, kr, tm, _ = video_dit.video_mask_ranges(cfg)
        keys = {"dit_tp": api.magi_attn_flex_key(
                    qr, kr, tm, cfg.seqlen, cfg.seqlen, mesh=mesh, cp_axis="cp", head_axis="tp",
                    device="cpu", chunk_size=cfg.tokens_per_frame // 2),
                "dit_tpfull": video_dit.make_video_attn_key(cfg, mesh=mesh, device="cpu")}
        for tag, key in keys.items():
            loss, g = video_dit.value_and_grad(params, cfg, clean, noise, DIT_T, key)
            res[f"{tag}_loss"] = float(loss)
            res.update({f"{tag}_g{j}": x.numpy() for j, x in enumerate(
                gather_leaves(g, params, video_dit.LAYOUT))})

        # the MoE at (cp 2, tp 2) with EP over the cp axis: the same row
        # blocks per EP rank as EP over tp
        cfg, layout, _ = fam["moe"]
        key = key_of("moe", mesh)
        params = moe.shard_moe_params(moe.moe_params_from_numpy(trees["moe"], "cpu"), mesh,
                                      ep_axis="cp")
        params, loss = moe.moe_train_step(params, cfg, m_tokens, m_labels, key, "cp", lr=SHARD_LR)
        res["moe_ep_cp22_loss"] = float(loss)
        gathered("moe_ep_cp22_", params, layout)
        # EP over tp on the whole (unsharded) tree: each rank's block of the
        # whole stacks, their gradients summed over the EP line
        params = moe.moe_params_from_numpy(trees["moe"], "cpu")
        params, loss = moe.moe_train_step(params, cfg, m_tokens, m_labels, key, "tp", lr=SHARD_LR)
        res["moe_ep_tp_whole_loss"] = float(loss)
        gathered("moe_ep_tp_whole_", params, layout)
        np.savez(os.path.join(out_dir, f"shard_{rank}.npz"), **res)
        dist.barrier()  # leave together: no rank closes a peer's open connections
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the resilience plane at cp 2 (tests/test_torch_resilience.py, slow)
# ---------------------------------------------------------------------------


def resilience_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of a gloo group: the API at tiles pinned 128 x 64, then at
    128 x 128 with ``kernel_lowering:count=1`` and MAGI_ATTENTION_FALLBACK=1
    (every rank arms the same spec, so every rank takes the same hop);
    forward and backward of each, with the ladder's recovered hops, to
    ``out_dir/rank<r>.npz``; then a forward under the step watchdog with a
    NaN on rank 0 alone (what each rank raised, "ok" for none, its hops
    and its output) beside the forward pinned at the next rung, sdpa."""
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from magiattention_tpu_torch import api, telemetry
    from magiattention_tpu_torch.env.general import scoped_env

    def step(env: dict):
        with scoped_env(env):
            key = api.magi_attn_flex_key(
                [(0, CP_SEQ)], [(0, CP_SEQ)], [1], CP_SEQ, CP_SEQ, cp_group=dist.group.WORLD,
                device="cpu", chunk_size=CP_CHUNK,
            )
            q, k, v, do = (torch.from_numpy(a) for a in cp_inputs(5))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out_d, _ = api.calc_attn(
                api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
                api.dispatch(leaves[2], key, role="kv"), key,
            )
            out = api.undispatch(out_d, key)
            (out * do).sum().backward()
            return np.concatenate([out.detach().numpy().ravel(), leaves[0].grad.numpy().ravel()])

    try:
        tiles = {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "64"}
        pinned = step(tiles)
        faulted = step({
            **tiles, "MAGI_ATTENTION_FFA_BLOCK_K": "128",
            "MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=1", "MAGI_ATTENTION_FALLBACK": "1",
            "MAGI_ATTENTION_TELEMETRY": "1", "MAGI_ATTENTION_TELEMETRY_DIR": os.path.join(out_dir, f"tel{rank}"),
        })
        with scoped_env({"MAGI_ATTENTION_TELEMETRY": "1",
                         "MAGI_ATTENTION_TELEMETRY_DIR": os.path.join(out_dir, f"tel{rank}")}):
            hops = telemetry.summary()["counters"].get("resilience.recovered", 0)
        # a NaN on rank 0 alone under the step watchdog (forward only): the
        # ranks agree on it and both hop to the next rung, held against
        # each rank's run pinned there
        def fwd(env: dict) -> np.ndarray:
            with torch.no_grad(), scoped_env(env):
                key = api.magi_attn_flex_key(
                    [(0, CP_SEQ)], [(0, CP_SEQ)], [1], CP_SEQ, CP_SEQ, cp_group=dist.group.WORLD,
                    device="cpu", chunk_size=CP_CHUNK,
                )
                q, k, v, _ = (torch.from_numpy(a) for a in cp_inputs(5))
                out, _ = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key, role="kv"),
                                       api.dispatch(v, key, role="kv"), key)
            return out.numpy()

        nan_pinned = fwd({"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"})
        nan_env = {"MAGI_ATTENTION_STEP_RETRIES": "1", "MAGI_ATTENTION_NUMERIC_GUARD": "raise"}
        if rank == 0:
            nan_env["MAGI_ATTENTION_FAULT_INJECT"] = "nan_output:count=1"
        before = telemetry.counters("resilience.").get("resilience.recovered", 0)
        nan_out = np.zeros(0, np.float32)
        try:
            nan_out = fwd(nan_env)
            nan_step = "ok"
        except Exception as e:  # noqa: BLE001  (the rank's outcome is the result)
            nan_step = type(e).__name__
        nan_hops = telemetry.counters("resilience.").get("resilience.recovered", 0) - before
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), pinned=pinned, faulted=faulted, hops=hops,
                 nan_step=nan_step, nan_out=nan_out, nan_pinned=nan_pinned, nan_hops=nan_hops)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the plan tiers (tests/test_torch_plan_store.py): a cp 2 gloo world over the
# broadcast tier, and the file transport across two processes
# ---------------------------------------------------------------------------

PLAN_DOCS = [(0, CP_SEQ // 2), (CP_SEQ // 2, CP_SEQ)]
PLAN_TIER_ENV = (
    "MAGI_ATTENTION_PLAN_STORE", "MAGI_ATTENTION_PLAN_STORE_DIR", "MAGI_ATTENTION_PLAN_BROADCAST",
    "MAGI_ATTENTION_PLAN_BROADCAST_TRANSPORT", "MAGI_ATTENTION_PLAN_BROADCAST_DIR",
    "MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "MAGI_ATTENTION_FAULT_INJECT", "MAGI_ATTENTION_FALLBACK",
)


def plan_key(cp_group=None):
    """The plan tiers' key: two causal documents of ``CP_SEQ`` tokens."""
    from magiattention_tpu_torch import api

    return api.magi_attn_flex_key(
        PLAN_DOCS, PLAN_DOCS, [1, 1], CP_SEQ, CP_SEQ, cp_group=cp_group, device="cpu",
        chunk_size=CP_CHUNK,
    )


def plan_step(key, seed: int = 7) -> np.ndarray:
    """out and dq, dk, dv of one fwd+bwd through ``key``'s API path, flat."""
    from magiattention_tpu_torch import api

    q, k, v, do = (torch.from_numpy(a) for a in cp_inputs(seed))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out_d, _ = api.calc_attn(
        api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
        api.dispatch(leaves[2], key, role="kv"), key,
    )
    out = api.undispatch(out_d, key)
    (out * do).sum().backward()
    return np.concatenate([out.detach().numpy().ravel()] + [t.grad.numpy().ravel() for t in leaves])


def forget_plans() -> None:
    """Drop the in-process tiers: the manager LRU and the plan memory LRU."""
    from magiattention_tpu_torch.api.magi_attn_interface import clear_cache
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE
    from magiattention_tpu_torch.meta import plan_store

    clear_cache()
    _PLAN_CACHE.clear()
    plan_store.reset()


def count_solves(mgr_mod, patch=setattr) -> dict:
    """Wrap the solver entry points the manager calls (through ``patch``,
    e.g. a test's ``monkeypatch.setattr``); returns the live counts."""
    calls = {"dispatch": 0, "static": 0}
    for name, attr in (("dispatch", "make_dispatch_meta_from_qk_ranges"),
                       ("static", "make_attn_meta_from_dispatch_meta")):
        real = getattr(mgr_mod, attr)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        patch(mgr_mod, attr, wrapped)
    return calls


def plan_bcast_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of a gloo group (a 60 s timeout: a broken pairing of the
    broadcast's collectives fails instead of hanging): a cold solve and its
    step; then, with the tiers forgotten, the broadcast tier (rank 0
    solves, rank 1 receives): its sources, its solves and its step; a
    memory-hit resolution under the broadcast (every rank exchanges once);
    a ``plan_broadcast`` fault on every rank under MAGI_ATTENTION_FALLBACK=1
    (rank 1 solves locally). To ``out_dir/rank<r>.npz``."""
    import datetime
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from magiattention_tpu_torch import dist_attn_runtime_mgr as mgr_mod
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr, clear_cache
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.resilience import inject

    try:
        with scoped_env({k: None for k in PLAN_TIER_ENV}):
            cold_key = plan_key(dist.group.WORLD)
            cold_source = _mgr(cold_key).plan_source
            cold = plan_step(cold_key)
            forget_plans()
            calls = count_solves(mgr_mod)
            with scoped_env({"MAGI_ATTENTION_PLAN_BROADCAST": "1"}):
                key = plan_key(dist.group.WORLD)
                source = _mgr(key).plan_source
                solves = dict(calls)
                bcast = plan_step(key)
                clear_cache()  # the plan memory tier stays warm: a hit
                hit_source = _mgr(plan_key(dist.group.WORLD)).plan_source
                forget_plans()
                inject.reset()
                with scoped_env({"MAGI_ATTENTION_FAULT_INJECT": "plan_broadcast:count=1",
                                 "MAGI_ATTENTION_FALLBACK": "1"}):
                    fkey = plan_key(dist.group.WORLD)
                    fault_source = _mgr(fkey).plan_source
                    faulted = plan_step(fkey)
                inject.reset()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), cold=cold, bcast=bcast, faulted=faulted,
                 sources=np.array([cold_source, source, hit_source, fault_source]),
                 solves=np.array([solves["dispatch"], solves["static"]]))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def plan_file_worker(role: str, directory: str, out_dir: str) -> None:
    """One process of the file transport: the leader cold-solves and
    publishes, then finds its published blob corrupted, and a warm
    resolution heals it; the follower (a later process) receives it."""
    import os

    from magiattention_tpu_torch.api.magi_attn_interface import _mgr, clear_cache
    from magiattention_tpu_torch.env.general import scoped_env

    torch.set_num_threads(1)
    env = {k: None for k in PLAN_TIER_ENV}
    env.update({"MAGI_ATTENTION_PLAN_BROADCAST": "1", "MAGI_ATTENTION_PLAN_BROADCAST_TRANSPORT": "file",
                "MAGI_ATTENTION_PLAN_BROADCAST_DIR": directory, "MAGI_ATTENTION_PLAN_BROADCAST_ROLE": role})
    with scoped_env(env):
        key = plan_key()
        sources = [_mgr(key).plan_source]
        out = plan_step(key)
        healed = False
        if role == "leader":
            (name,) = os.listdir(directory)
            path = os.path.join(directory, name)
            with open(path, "rb") as f:
                pristine = f.read()
            with open(path, "wb") as f:
                f.write(pristine[: len(pristine) // 2])  # a torn publish
            clear_cache()  # the plan memory tier stays warm: the heal probe runs
            sources.append(_mgr(plan_key()).plan_source)
            with open(path, "rb") as f:
                healed = f.read() == pristine
    np.savez(os.path.join(out_dir, f"{role}.npz"), out=out, sources=np.array(sources), healed=healed)
