"""The split page walk of B10, B11 and B12, what surrounds it, on the CPU.

The split walk (``csrc/paged_decode.cuh``) runs only on the card. Pinned
here: the plan ``decode_split_plan`` gives (whole 64-token units covering
the table, from the cache's shape and the SM count alone), the workspace
and arguments the three wrappers launch with (through a stand-in that
records the C calls), the C entry points' argument counts against the
bindings, every entry on the split walk, and CPU tensors taking the plain
versions with the kernel counters untouched.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from magiattention_tpu_torch.kernels import _build, launch_counts
from magiattention_tpu_torch.kernels import paged_decode as pd
from magiattention_tpu_torch.kernels import paged_kv as tpk
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

# (P, ps, S, hk, sms): the serving cells, the edge cases' tables, page
# sizes 1..128, one slot to many, 1..8 kv heads, small and full cards
SHAPES = [
    (256, 16, 8, 8, 132), (256, 16, 8, 4, 132), (40, 8, 4, 1, 132),
    (40, 128, 4, 2, 132), (4, 8, 7, 2, 132), (16, 16, 2, 2, 132),
    (2048, 16, 1, 8, 132), (8192, 16, 256, 8, 132), (64, 1, 3, 1, 132),
    (1, 1, 1, 1, 1), (3, 100, 5, 3, 7), (512, 128, 64, 8, 114),
    (256, 16, 8, 8, 1), (1000, 16, 32, 1, 132),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "P{}_ps{}_S{}_hk{}_sm{}".format(*s))
def test_plan_is_whole_units_covering_the_table(shape):
    P, ps, S, hk, sms = shape
    splits, split_len = pd.decode_split_plan(P, ps, hk, sms)
    assert split_len % pd.SPLIT_UNIT == 0 and split_len % 64 == 0
    assert split_len >= pd.MIN_SPLIT_TOKENS
    assert splits >= 1 and splits * split_len >= P * ps  # covers the table
    assert (splits - 1) * split_len < P * ps  # no split past it
    # one long slot gets at most one CTA an SM (or one split a slot)
    assert splits == 1 or hk * (splits - 1) < sms
    # a cache of S slots launches the plan of its table, whatever S
    cache = tpk.PagedKVCache.create(1, ps, hk, 64, S, P, device="cpu")
    assert pd.split_plan_of(cache, sms) == (splits, split_len)


def test_plan_at_the_serving_shape():
    """chip_smoke's decode cells: 16 splits of 256 tokens on 132 SMs, at
    hk 8 and 4 alike."""
    assert pd.decode_split_plan(256, 16, 8, 132) == (16, 256)
    assert pd.decode_split_plan(256, 16, 4, 132) == (16, 256)
    assert pd.decode_split_plan(4, 8, 2, 132) == (1, 256)
    with pytest.raises(ValueError):
        pd.decode_split_plan(0, 16, 8, 132)


def _cache(lengths, P=64, ps=16, hk=2, d=64, num_pages=24, seed=0, dtype=torch.float32):
    """A CPU cache of random pages with ``lengths`` (pages assigned from a
    permutation, -1 table tails)."""
    rng = np.random.default_rng(seed)
    cache = tpk.PagedKVCache.create(num_pages, ps, hk, d, len(lengths), P,
                                    dtype=dtype, device="cpu")
    cache.k_pages.copy_(torch.from_numpy(rng.standard_normal(cache.k_pages.shape)))
    cache.v_pages.copy_(torch.from_numpy(rng.standard_normal(cache.v_pages.shape)))
    free = list(rng.permutation(num_pages))
    for s, length in enumerate(lengths):
        n = -(-length // ps)
        tpk.assign_pages(cache, s, np.asarray(free[:n], np.int32))
        free = free[n:]
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def test_plan_reads_the_shape_not_the_lengths():
    """The plan's inputs are the cache's shape and the SM count: two caches
    of one shape with other lengths and pages launch the same plan."""
    assert list(inspect.signature(pd.decode_split_plan).parameters) == [
        "P", "ps", "hk", "sms"]
    a = _cache([0, 300], seed=1)
    b = _cache([1000, 17], seed=2)
    assert pd.split_plan_of(a, 132) == pd.split_plan_of(b, 132) == (4, 256)


class _Recorder:
    """Stands in for a kernel library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers with the library, device checks, stream and SM count
    stood in for (CPU tensors): the C calls and the workspaces allocated."""
    rec, spaces = _Recorder(), []
    real_workspace = pd.split_workspace

    def workspace(splits, rows, d, device):
        t = real_workspace(splits, rows, d, device)
        spaces.append((splits, rows, d, None if t is None else t.numel()))
        return t

    monkeypatch.setattr(pd, "_lib", lambda name: rec)
    monkeypatch.setattr(pd, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(pd, "_stream", lambda q: 0)
    monkeypatch.setattr(pd, "_sm_count", lambda device: 132)
    monkeypatch.setattr(pd, "split_workspace", workspace)
    for fn in (pd.paged_decode_kernel, pd.paged_decode_spec_kernel,
               pd.paged_decode_int8_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    return rec, spaces


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b10_and_b11_launch_one_plan_at_every_spec_k(recorded, dtype):
    """B10 and B11 at spec_k 1, 2 and 4 pass the same (splits, split_len),
    a workspace of splits x S * spec_k * hq x (d + 2) floats, and count one
    launch each."""
    rec, spaces = recorded
    cache = _cache([0, 300], dtype=dtype)
    S, hq, d = 2, 4, 64
    scale = d ** -0.5
    pd.paged_decode_kernel(torch.zeros(S, hq, d, dtype=dtype), cache, scale)
    for spec_k in (1, 2, 4):
        pd.paged_decode_spec_kernel(torch.zeros(S, spec_k, hq, d, dtype=dtype), cache, scale)
    suffix = "f32" if dtype == torch.float32 else "bf16"
    names = [name for name, _ in rec.calls]
    assert names == [f"paged_decode_{suffix}"] + [f"paged_decode_spec_{suffix}"] * 3
    b10 = rec.calls[0][1]
    plans = [b10[14:16]] + [args[15:17] for _, args in rec.calls[1:]]
    assert plans == [(4, 256)] * 4
    for (name, args), (splits, rows, dd, numel), spec_k in zip(rec.calls, spaces, (1, 1, 2, 4)):
        assert (splits, rows, dd) == (4, S * spec_k * hq, d)
        assert numel == splits * rows * (d + 2)
        assert args[7] is not None  # the workspace's pointer
    assert pd.paged_decode_kernel.launches == 1
    assert pd.paged_decode_spec_kernel.launches == 3


# wrapper -> (its int8 flag, the index of the workspace pointer and of
# (splits, split_len) in its C call)
WRAPPERS = {
    "paged_decode": (False, 7, 14),
    "paged_decode_int8": (True, 9, 16),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_one_split_launches_without_a_workspace(recorded, kernel):
    """A table no longer than one split: no workspace, a null pointer."""
    rec, spaces = recorded
    quant, ws, plan = WRAPPERS[kernel]
    cache = _cache([5, 16], P=4, num_pages=8,
                   dtype=torch.int8 if quant else torch.float32)
    getattr(pd, f"{kernel}_kernel")(torch.zeros(2, 4, 64), cache, 0.125)
    (_, args), = rec.calls
    assert args[plan:plan + 2] == (1, 256) and args[ws] is None
    assert spaces == [(1, 8, 64, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b12_launches_the_split_plan(recorded, dtype):
    """B12 over int8 pages, q float32 or bf16: B10's plan for the cache's
    shape, a workspace of splits x S * hq x (d + 2) floats and its pointer,
    the scales' pointers, one launch counted."""
    rec, spaces = recorded
    cache = _cache([0, 300], dtype=torch.int8)
    S, hq, d = 2, 4, 64
    pd.paged_decode_int8_kernel(torch.zeros(S, hq, d, dtype=dtype), cache, d ** -0.5)
    (name, args), = rec.calls
    assert name == "paged_decode_int8_" + ("f32" if dtype == torch.float32 else "bf16")
    assert len(args) == len(pd._ARGTYPES["paged_decode_int8"])
    assert args[16:18] == pd.split_plan_of(cache, 132) == (4, 256)
    assert spaces == [(4, S * hq, d, 4 * S * hq * (d + 2))]
    assert args[9] is not None
    assert args[3:5] == (cache.k_scales.data_ptr(), cache.v_scales.data_ptr())
    assert args[10:16] == (S, hq, 2, d, 16, 64)  # S hq hk d ps P
    assert pd.paged_decode_int8_kernel.launches == 1


@pytest.mark.parametrize("splits,rows,d", [(1, 8, 64), (2, 8, 64), (16, 1024, 128)])
def test_workspace_size_matches_the_plan(splits, rows, d):
    t = pd.split_workspace(splits, rows, d, "cpu")
    if splits == 1:
        assert t is None
    else:
        assert t.dtype == torch.float32 and t.numel() == splits * rows * (d + 2)


def _extern_c(source: str) -> dict[str, int]:
    found = {}
    for m in re.finditer(r'extern "C" \w+\*? (\w+)\(([^)]*)\)', source):
        found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", sorted(pd._ARGTYPES))
def test_entry_points_take_the_bindings_arguments(name):
    """``<name>_f32`` / ``_bf16`` are ``extern "C"`` in ``csrc/<name>.cu``
    with as many arguments as ``_lib`` binds, each taking the workspace and
    the plan (``part``, ``splits``, ``split_len``): every entry dispatches
    the one (split) walk of the body."""
    assert name in _build.SOURCES
    src = (_build.CSRC / f"{name}.cu").read_text()
    exported = _extern_c(src)
    for suffix in ("f32", "bf16"):
        assert exported.get(f"{name}_{suffix}") == len(pd._ARGTYPES[name])
    for m in re.finditer(r'extern "C" int \w+\(([^)]*)\)', src):
        params = [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]
        assert {"part", "splits", "split_len"} <= set(params)
    assert re.findall(r"magi::decode::dispatch<", src)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the entry points run the plain versions; no kernel
    counter moves."""
    cache = _cache([0, 300])
    before = launch_counts()
    pd.paged_decode_attn(torch.zeros(2, 4, 64), cache)
    pd.paged_decode_attn_spec(torch.zeros(2, 3, 4, 64), cache)
    after = launch_counts()
    assert after["paged_decode_plain"] == before["paged_decode_plain"] + 1
    assert after["paged_decode_spec_plain"] == before["paged_decode_spec_plain"] + 1
    for name in ("paged_decode", "paged_decode_spec", "paged_decode_int8"):
        assert after[name] == before[name]
