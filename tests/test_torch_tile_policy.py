"""The port's tile policy, shared-memory budget and backend registry
against the JAX package's.

The counting functions (``count_ffa_work``, ``count_ffa_work_t``,
``slice_cover_tiles`` / ``_ratios``, ``plan_extent_stats``,
``fragmentation_histogram``) depend on geometry alone: they must equal the
JAX package's array for array on the mask families of
``tests/test_attn/test_sparse_dispatch.py``, at the JAX package's tile pairs
and at the ones compiled for the card. The choosers (``choose_blocks*``,
``choose_mixed_dispatch``, ``reachable_block_space``), handed the JAX
package's space (its candidates, quanta, band extras, fallback, overhead,
merge cost and VMEM guard), must pick what it picks. Registry decisions and
pins must equal the JAX package's under the same env. Then what is the
card's own: the compiled sets against the instance lists of the CUDA
sources, the shared-memory formula at the 64 x 64 figures the kernels had,
a pinned tile winning over the policy, an override the pass's kernel is
not compiled for inheriting the forward's tiles, and the backward-mode
model reading per-pass tiles. Exact comparisons throughout (integers, and
ratios of the same integer products).
"""

import re

import numpy as np
import pytest

from magiattention_tpu.analysis.kernel_check import _fragmented_masks
from magiattention_tpu.env import backend as jax_env_backend
from magiattention_tpu.kernels import ffa_plan as jax_plan
from magiattention_tpu.kernels import registry as jax_registry
from magiattention_tpu.kernels import tile_policy as jax_tp
from magiattention_tpu.kernels.mask_utils import types_to_bands
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels import ffa_plan as port_plan
from magiattention_tpu_torch.kernels import registry as port_registry
from magiattention_tpu_torch.kernels import tile_policy as port_tp
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.utils import mem_budget

from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

S = 512
FULL, CAUSAL = 0, 1


def _families(seq=S):
    """name -> (q_ranges, k_ranges, d_lo, d_hi): the sparse-dispatch test
    families (full, causal, sliding window, shared prefix, video, block
    diagonal)."""
    one = np.asarray([[0, seq]], np.int32)
    h = seq // 2
    spq = np.asarray([[0, h], [h, seq], [h, seq]], np.int32)
    spk = np.asarray([[0, h], [0, h // 2], [h, seq]], np.int32)
    fams = {
        "full": (one, one.copy(), *types_to_bands(one, one, np.asarray([FULL], np.int32))),
        "causal": (one, one.copy(), *types_to_bands(one, one, np.asarray([CAUSAL], np.int32))),
        "sliding_window": (one, one.copy(), np.asarray([-128], np.int32), np.asarray([0], np.int32)),
        "shared_prefix_causal": (
            spq, spk, *types_to_bands(spq, spk, np.asarray([CAUSAL, FULL, CAUSAL], np.int32))
        ),
    }
    fams.update(_fragmented_masks(seq))
    return fams


FAMILIES = _families()
# the JAX package's tile pairs and the card's compiled ones
TILES = [(128, 128), (256, 512), (64, 64), (128, 64), (64, 128)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in (
        "MAGI_ATTENTION_FFA_BLOCK_Q", "MAGI_ATTENTION_FFA_BLOCK_K",
        "MAGI_ATTENTION_FFA_BLOCK_Q_DQ", "MAGI_ATTENTION_FFA_BLOCK_K_DQ",
        "MAGI_ATTENTION_FFA_BLOCK_Q_DKV", "MAGI_ATTENTION_FFA_BLOCK_K_DKV",
        "MAGI_ATTENTION_FFA_AUTO_TILE", "MAGI_ATTENTION_FFA_MIXED_BLOCKS",
        "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", "MAGI_ATTENTION_KERNEL_BACKEND",
        "MAGI_ATTENTION_BACKEND_NSA_SLC", "MAGI_ATTENTION_BACKEND_FFA_BWD",
        "MAGI_ATTENTION_FFA_FUSED_BWD", "MAGI_ATTENTION_BACKEND_SERVE_DECODE",
        "MAGI_ATTENTION_SERVE_DECODE_KERNEL", "MAGI_ATTENTION_FFA_GQA_PACK",
        "MAGI_ATTENTION_FFA_GQA_PACK_DQ", "MAGI_ATTENTION_FFA_GQA_PACK_DKV",
    ):
        monkeypatch.delenv(key, raising=False)


# ---------------------------------------------------------------------------
# counting: geometry alone, equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiles", TILES, ids=str)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_counts_equal_jax(family, tiles):
    qr, kr, lo, hi = FAMILIES[family]
    bq, bk = tiles
    for fn in ("count_ffa_work", "count_ffa_work_t"):
        got = getattr(port_tp, fn)(qr, kr, lo, hi, S, S, bq, bk)
        assert got == getattr(jax_tp, fn)(qr, kr, lo, hi, S, S, bq, bk), fn
    got = port_tp.slice_cover_tiles(qr, kr, lo, hi, bq, bk)
    want = jax_tp.slice_cover_tiles(qr, kr, lo, hi, bq, bk)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ratios = port_tp.slice_cover_ratios(qr, kr, lo, hi, bq, bk)
    assert np.array_equal(ratios, jax_tp.slice_cover_ratios(qr, kr, lo, hi, bq, bk))
    assert port_plan.fragmentation_histogram(ratios) == jax_plan.fragmentation_histogram(ratios)


@pytest.mark.parametrize("tiles", TILES, ids=str)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_counts_equal_the_builders(family, tiles):
    """The closed forms count what the port's plan builder lists: its
    q-major and k-major items."""
    qr, kr, lo, hi = FAMILIES[family]
    plan = port_plan.build_ffa_plan(qr, kr, lo, hi, S, S, *tiles)
    assert port_tp.count_ffa_work(qr, kr, lo, hi, S, S, *tiles) == plan.num_work
    assert port_tp.count_ffa_work_t(qr, kr, lo, hi, S, S, *tiles) == plan.num_work_t


@pytest.mark.parametrize("tiles", [(128, 128), (256, 512), (64, 128)], ids=str)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_extent_stats_equal_jax(family, tiles):
    """At the JAX package's extent quanta (8, 128) the port's plan gives
    its executed/padded accounting exactly."""
    qr, kr, lo, hi = FAMILIES[family]
    got = port_plan.build_ffa_plan(qr, kr, lo, hi, S, S, *tiles, quanta=(8, 128))
    want = jax_plan.build_ffa_plan(qr, kr, lo, hi, S, S, *tiles)
    assert port_plan.plan_extent_stats(got) == jax_plan.plan_extent_stats(want)


def test_band_area_equals_jax():
    from magiattention_tpu.telemetry.stats import band_area

    for family, (qr, kr, lo, hi) in FAMILIES.items():
        assert port_tp.band_area(qr, kr, lo, hi) == band_area(qr, kr, lo, hi), family


# ---------------------------------------------------------------------------
# the choosers, handed the JAX package's space, pick what it picks
# ---------------------------------------------------------------------------


def _jax_fits(kind, bq, bk, d, dv, itemsize):
    if kind == "fwd":
        return jax_tp._vmem_bytes(bq, bk, d, dv, itemsize) <= jax_tp.VMEM_BUDGET
    return jax_tp._bwd_vmem_bytes(kind, bq, bk, d, dv, itemsize) <= jax_tp.VMEM_BUDGET


JAX_SPACE = port_tp.TileSpace(
    candidates=jax_tp.CANDIDATES, quantum_q=16, quantum_k=jax_tp.NUM_LANES,
    band_q=(128, 256, 512), band_k_max=1024, fallback=(256, 512),
    overhead=jax_tp.OVERHEAD_ELEMS, merge_per_row=jax_tp.MERGE_OVERHEAD_PER_ROW,
    fits=_jax_fits, bwd_divides=True,
)


def _geoms(seq):
    """Chooser geometries: the families at 4096 and 8192 tokens, and a
    dense causal and a narrow window at the headline length."""
    out = {f"{name}_{s}": g for s in (4096, 8192) for name, g in _families(s).items()}
    one = np.asarray([[0, 8192]], np.int32)
    out["window_64_8192"] = (one, one.copy(), np.asarray([-64], np.int32), np.asarray([0], np.int32))
    return out


GEOMS = _geoms(S)
DIMS = [(128, 2), (128, 4), (256, 2), (64, 4)]


@pytest.mark.parametrize("dims", DIMS, ids=str)
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_choosers_pick_what_jax_picks(geom, dims):
    d, itemsize = dims
    qr, kr, lo, hi = GEOMS[geom]
    s = int(max(qr.max(), kr.max()))
    got = port_tp.choose_blocks(qr, kr, lo, hi, s, s, d, d, itemsize, space=JAX_SPACE)
    assert got == jax_tp.choose_blocks(qr, kr, lo, hi, s, s, d, d, itemsize)
    got = port_tp.choose_blocks_per_pass(qr, kr, lo, hi, s, s, d, d, itemsize, space=JAX_SPACE)
    assert got == jax_tp.choose_blocks_per_pass(qr, kr, lo, hi, s, s, d, d, itemsize)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_reachable_space_equals_jax(kind, dims):
    d, itemsize = dims
    for s in (300, 4096, 8192):
        got = port_tp.reachable_block_space(s, s, kind, d, d, itemsize, space=JAX_SPACE)
        assert got == jax_tp.reachable_block_space(s, s, kind, d, d, itemsize), s


def _mixed_geoms():
    """Masks with dense and fragmented slices: the JAX test's canonical
    split (a dense half and a block-diagonal tail), the fragmented
    families beside a dense slice, and varlen tails of small documents."""
    out = {}
    for seq in (2048, 8192):
        h, blk = seq // 2, 128
        qr = np.asarray([[0, h]] + [[h + i * blk, h + (i + 1) * blk] for i in range((seq - h) // blk)], np.int32)
        out[f"dense_plus_blockdiag_{seq}"] = (qr, qr.copy(), *types_to_bands(qr, qr, np.zeros(len(qr), np.int32)))
        docs = [[0, h]] + [[h + i * 48, min(h + (i + 1) * 48, seq)] for i in range(-(-(seq - h) // 48))]
        dq = np.asarray(docs, np.int32)
        out[f"varlen_small_docs_{seq}"] = (dq, dq.copy(), *types_to_bands(dq, dq, np.ones(len(dq), np.int32)))
    return out


MIXED = _mixed_geoms()


@pytest.mark.parametrize("pin", [None, "mixed", "single"])
@pytest.mark.parametrize("geom", sorted(MIXED))
def test_mixed_dispatch_equals_jax(geom, pin, monkeypatch):
    qr, kr, lo, hi = MIXED[geom]
    s = int(qr.max())
    if pin is not None:
        monkeypatch.setenv("MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", pin)
    got = port_tp.choose_mixed_dispatch(qr, kr, lo, hi, s, s, 128, 128, 2, space=JAX_SPACE)
    want = jax_tp.choose_mixed_dispatch(qr, kr, lo, hi, s, s, 128, 128, 2)
    assert (got is None) == (want is None)
    if want is not None:
        for f in ("dense_idx", "frag_idx"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        for f in ("coarse_blocks", "fine_blocks", "single_score", "split_score"):
            assert getattr(got, f) == getattr(want, f), f
    if pin is None and geom.startswith("dense_plus_blockdiag"):
        assert got is not None  # the JAX test's canonical profitable split


# every fragmented family the chooser tests use, at the card's widths
HOPPER_MIXED = {**MIXED, **{f"{g}_f": GEOMS[g] for g in sorted(GEOMS)}}


@pytest.mark.parametrize("geom", sorted(HOPPER_MIXED))
def test_bf16_mixed_gate_declines_before_scoring(geom):
    """On the card's space in bf16 (no per-item overhead, coarse tiles at
    the 64 quantum) the gate returns None without hashing or scoring, and
    the full scoring, run on its own, returns None as well."""
    qr, kr, lo, hi = HOPPER_MIXED[geom]
    s = int(max(qr.max(), kr.max()))
    space = port_tp.hopper_space()
    for d in (64, 128):
        assert port_tp._choose_mixed(qr, kr, lo, hi, s, s, d, d, 2, (64, 64), space, None) is None
    port_registry.reset_registry()
    port_tp._MEMO.clear()
    assert port_tp.choose_mixed_dispatch(qr, kr, lo, hi, s, s, 128, 128, 2, coarse_blocks=(64, 64)) is None
    assert len(port_tp._MEMO) == 0
    assert port_registry.stats()["resolves"] == 0


def test_float32_mixed_gate_still_scores():
    """Where the dtype has a per-item overhead (float32) the gate scores
    and remembers the geometry."""
    qr, kr, lo, hi = MIXED["varlen_small_docs_2048"]
    port_tp._MEMO.clear()
    port_tp.choose_mixed_dispatch(qr, kr, lo, hi, 2048, 2048, 128, 128, 4, coarse_blocks=(64, 64))
    assert len(port_tp._MEMO) == 1


def test_mixed_key_equals_jax():
    qr, kr, lo, hi = MIXED["dense_plus_blockdiag_2048"]
    args = (qr, kr, lo, hi, 2048, 2048, 128, 128, 2, (256, 512))
    assert port_tp._mixed_dispatch_key(*args) == jax_tp._mixed_dispatch_key(*args)


# ---------------------------------------------------------------------------
# the backend registry
# ---------------------------------------------------------------------------

ENVS = [
    {},
    {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"},
    {"MAGI_ATTENTION_KERNEL_BACKEND": "SDPA_ONLINE"},
    {"MAGI_ATTENTION_BACKEND_NSA_SLC": "gathered_dense"},
    {"MAGI_ATTENTION_FFA_GQA_PACK": "1", "MAGI_ATTENTION_FFA_GQA_PACK_DKV": "0"},
    {"MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1"},
    {"MAGI_ATTENTION_FFA_MIXED_BLOCKS": "1"},
    {"MAGI_ATTENTION_FFA_MIXED_BLOCKS": "0"},
    {"MAGI_ATTENTION_BACKEND_MIXED_BLOCKS": "single", "MAGI_ATTENTION_FFA_MIXED_BLOCKS": "1"},
    {"MAGI_ATTENTION_FFA_FUSED_BWD": "1"},
    {"MAGI_ATTENTION_BACKEND_FFA_BWD": "split", "MAGI_ATTENTION_FFA_FUSED_BWD": "1"},
    {"MAGI_ATTENTION_SERVE_DECODE_KERNEL": "0"},
    {"MAGI_ATTENTION_BACKEND_SERVE_DECODE": "dense"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q": "128"},
    {"MAGI_ATTENTION_FFA_BLOCK_K": "64"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_registry_decisions_equal_jax(env, monkeypatch):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert port_registry.calc_attn_backend() == jax_registry.calc_attn_backend()
    assert port_registry.nsa_slc_backend() == jax_registry.nsa_slc_backend()
    assert port_registry.tiles_pinned() == jax_registry.tiles_pinned()
    for kind in ("fwd", "dq", "dkv"):
        assert port_registry.gqa_pack_variant(kind) == jax_registry.gqa_pack_variant(kind), kind
        assert port_ffa.gqa_pack_variant(kind) == jax_registry.gqa_pack_variant(kind), kind
    from magiattention_tpu_torch.env import backend as port_env_backend

    for pin in ("kernel_backend_pin", "mixed_blocks_pin", "ffa_bwd_pin", "serve_decode_pin", "nsa_slc_pin"):
        assert getattr(port_env_backend, pin)() == getattr(jax_env_backend, pin)(), pin


def test_ladders_name_the_ports_routes():
    """Every decision the two registries share ranks its backends alike;
    the serve-decode ladder is the JAX package's whole ladder, sharded rung
    on top, which the port's decode route walks."""
    from magiattention_tpu_torch.serving.decode import RUNGS

    for decision in port_registry.decisions():
        assert port_registry.ladder(decision) == jax_registry.ladder(decision), decision
    assert port_registry.ladder("serve_decode")[0] == "paged_decode_sharded"
    assert port_registry.ladder("serve_decode") == RUNGS
    assert set(port_registry.decisions()) == set(jax_registry.decisions()) - {"ffa_lowering"}
    for decision, keys in port_registry.PIN_KEYS.items():
        assert jax_registry.PIN_KEYS[decision] == keys, decision


def test_resolution_order():
    """pin > memo > heuristic, the heuristic run once per key."""
    port_registry.reset_registry()
    calls = []

    def heuristic():
        calls.append(1)
        return "single"

    assert port_registry.resolve("ffa_dispatch", ("k",), heuristic).source == "heuristic"
    assert port_registry.resolve("ffa_dispatch", ("k",), heuristic).name == "single"
    assert port_registry.resolve("ffa_dispatch", ("k",), heuristic, pin="mixed").name == "mixed"
    assert len(calls) == 1
    st = port_registry.stats()
    assert (st["resolves"], st["pins"], st["memo_hits"], st["heuristic_calls"]) == (3, 1, 1, 1)
    assert port_registry.last_choice("ffa_dispatch") == "mixed"


def test_registry_memo_is_bounded():
    """The memo keeps the :data:`MEMO_SIZE` most recently used keys of a
    decision: a key past the bound evicts the least recently used one,
    whose heuristic runs again, while a key just used stays."""
    port_registry.reset_registry()
    n = port_registry.MEMO_SIZE
    for i in range(n + 100):
        port_registry.resolve("ffa_bwd", ("geom", i), lambda: "split")
        if i >= 1:
            port_registry.resolve("ffa_bwd", ("geom", 1), lambda: "split")  # kept warm
    assert port_registry.memo_size("ffa_bwd") == n
    port_registry.resolve("ffa_dispatch", ("k",), lambda: "single")
    assert port_registry.memo_size("ffa_dispatch") == 1
    calls = port_registry.stats()["heuristic_calls"]
    port_registry.resolve("ffa_bwd", ("geom", 1), lambda: "split")
    port_registry.resolve("ffa_bwd", ("geom", n + 99), lambda: "split")
    assert port_registry.stats()["heuristic_calls"] == calls  # both memoized
    port_registry.resolve("ffa_bwd", ("geom", 0), lambda: "split")
    assert port_registry.stats()["heuristic_calls"] == calls + 1  # evicted, resolved again
    assert port_registry.memo_size("ffa_bwd") == n


# ---------------------------------------------------------------------------
# the card's side: compiled sets, the shared-memory formula, pins
# ---------------------------------------------------------------------------


def _macro(src: str, name: str) -> set[tuple[int, ...]]:
    body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S)
    assert body, name
    return {tuple(int(x) for x in m.split(",")) for m in re.findall(r"X\(([\d, ]+)\)", body.group(1))}


def test_compiled_sets_are_the_sources_instances():
    """The tile pairs of ``utils/mem_budget.py`` are the sources' instance
    lists (csrc/common.cuh MAGI_FFA_TILES; the packed kernels' own), and a
    pair is compiled where its CTA fits the budget."""
    common = (_build.CSRC / "common.cuh").read_text()
    tiles = _macro(common, "MAGI_FFA_TILES")
    assert tiles == {(d, bq, bk) for d in (64, 128, 256) for bq, bk in mem_budget.TILE_PAIRS}
    fwd_gqa = (_build.CSRC / "ffa_fwd_gqa.cu").read_text()
    assert _macro(fwd_gqa, "MAGI_FWD_GQA") == mem_budget.PACKED_INSTANCES[("fwd_gqa", 2)]
    assert _macro(fwd_gqa, "MAGI_FWD_GQA_F32") == mem_budget.PACKED_INSTANCES[("fwd_gqa", 4)]
    dq_gqa = (_build.CSRC / "ffa_bwd_dq_gqa.cu").read_text()
    assert {(d, 2, bk) for d, bk in _macro(dq_gqa, "MAGI_DQ_GQA")} == mem_budget.PACKED_INSTANCES[("dq_gqa", 2)]
    for itemsize in (2, 4):  # the k-major pass's set serves dk/dv and fused
        for d in (64, 128, 256):
            assert mem_budget.compiled_tiles("fused", itemsize, d) == mem_budget.compiled_tiles("dkv", itemsize, d)
    for kernel in ("fwd", "dq", "dkv", "fused"):
        for itemsize in (2, 4):
            for d in (64, 128, 256):
                got = mem_budget.compiled_tiles(kernel, itemsize, d)
                assert mem_budget.DEFAULT_TILES in got, (kernel, itemsize, d)
                for bq, bk in got:
                    assert mem_budget.ffa_smem_bytes(kernel, d, bq, bk, itemsize) <= mem_budget.SMEM_PER_CTA


@pytest.mark.parametrize(
    "kernel,itemsize,d,want",
    [
        ("fwd", 2, 128, ((64, 64), (128, 64), (64, 128), (128, 128))),
        ("fwd", 2, 256, ((64, 64), (128, 64), (64, 128))),
        ("fwd", 4, 128, ((64, 64), (128, 64), (64, 128), (128, 128))),
        ("fwd", 4, 256, ((64, 64), (64, 128))),
        ("dq", 2, 128, ((64, 64), (128, 64), (64, 128), (128, 128))),
        ("dq", 2, 256, ((64, 64),)),
        ("dq", 4, 128, ((64, 64),)),
        ("dkv", 2, 128, ((64, 64), (128, 64), (64, 128), (128, 128))),
        ("dkv", 2, 256, ((64, 64),)),
        ("fused", 2, 64, ((64, 64), (128, 64), (64, 128), (128, 128))),
        ("fused", 4, 64, ((64, 64),)),
        ("fwd", 2, 32, ()),
    ],
)
def test_compiled_sets(kernel, itemsize, d, want):
    assert mem_budget.compiled_tiles(kernel, itemsize, d) == want


def test_smem_formula_keeps_the_64x64_figures():
    """At 64 x 64 the formula is the one the kernels were held to before
    the tile instances (their ``<name>_smem_bytes`` on the card)."""
    assert mem_budget.fwd_smem_bytes(128) == 82_960
    assert mem_budget.fwd_smem_bytes(128, itemsize=4, heads=2) == 230_432
    assert mem_budget.dq_smem_bytes(128) == 99_328
    assert mem_budget.dq_smem_bytes(128, heads=2) == 132_096
    assert mem_budget.dkv_smem_bytes(128) == 100_352
    assert mem_budget.dkv_smem_bytes(128, fused=True) == 108_544
    assert mem_budget.dkv_smem_bytes(256, fused=True) == 206_848
    # the 128-row tiles: a 128 x 128 forward at d 128 takes 160 KB, at d 256
    # it does not fit
    assert mem_budget.fwd_smem_bytes(128, 128, 128) == 164_896
    assert mem_budget.fwd_smem_bytes(256, 128, 128) > mem_budget.SMEM_PER_CTA
    assert mem_budget.ctas_per_sm("dq", 128) == 2
    assert mem_budget.ctas_per_sm("fwd", 128, 128, 128) == 1


def test_hopper_picks_are_compiled():
    """The card's space only ever picks compiled pairs, per pass and
    dtype, and its reachable space is inside the compiled set."""
    for name, (qr, kr, lo, hi) in GEOMS.items():
        s = int(max(qr.max(), kr.max()))
        for itemsize in (2, 4):
            fwd, dq, dkv = port_tp.choose_blocks_per_pass(qr, kr, lo, hi, s, s, 128, 128, itemsize)
            assert fwd in mem_budget.compiled_tiles("fwd", itemsize, 128), name
            assert (dq or fwd) in mem_budget.compiled_tiles("dq", itemsize, 128), name
            assert (dkv or fwd) in mem_budget.compiled_tiles("dkv", itemsize, 128), name
    for kind in ("fwd", "dq", "dkv"):
        for itemsize in (2, 4):
            reach = port_tp.reachable_block_space(8192, 8192, kind, 128, 128, itemsize)
            assert set(reach) <= set(mem_budget.compiled_tiles(kind, itemsize, 128))


def _causal(s):
    one = np.asarray([[0, s]], np.int32)
    return one, one.copy(), *types_to_bands(one, one, np.asarray([CAUSAL], np.int32))


def test_pinned_tile_beats_the_policy(monkeypatch):
    """Explicit tiles (argument or env) always win over auto-tile, and
    turn the mixed gate off."""
    qr, kr, lo, hi = _causal(4096)
    monkeypatch.setenv("MAGI_ATTENTION_FFA_AUTO_TILE", "1")
    monkeypatch.setattr(port_tp, "OVERHEAD_ELEMS", {2: 10**6, 4: 10**6})  # the policy wants 128 x 128
    auto = port_ffa.resolve_dispatch(qr, kr, lo, hi, 4096, 4096, 128, 128, 2)
    assert auto.blocks == (128, 128)
    assert port_ffa.resolve_dispatch(qr, kr, lo, hi, 4096, 4096, 128, 128, 2, 64, 64).blocks == (64, 64)
    monkeypatch.setenv("MAGI_ATTENTION_FFA_BLOCK_Q", "64")
    pinned = port_ffa.resolve_dispatch(qr, kr, lo, hi, 4096, 4096, 128, 128, 2)
    assert pinned.blocks == (64, 64) and pinned.mixed is None and pinned.overrides == {}


def test_uncompiled_override_inherits_the_forward(monkeypatch):
    """A per-pass pin the pass's kernel is not compiled for (dtype, width)
    leaves that pass at the forward's tiles; a compiled one is taken, and
    env wins over the policy's pick component-wise."""
    monkeypatch.setenv("MAGI_ATTENTION_FFA_BLOCK_Q_DQ", "32")
    assert port_ffa.resolve_bwd_overrides(64, 64, 128, 2)[0] is None
    monkeypatch.setenv("MAGI_ATTENTION_FFA_BLOCK_Q_DQ", "128")
    assert port_ffa.resolve_bwd_overrides(64, 64, 128, 2) == ((128, 64), None)
    # float32: the CUDA-core backward is 64 x 64 only
    assert port_ffa.resolve_bwd_overrides(64, 64, 128, 4) == (None, None)
    # d 256: dq takes 64 x 64 only
    assert port_ffa.resolve_bwd_overrides(64, 64, 256, 2) == (None, None)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_BLOCK_Q_DQ")
    monkeypatch.setenv("MAGI_ATTENTION_FFA_BLOCK_K_DKV", "64")
    got = port_ffa.resolve_bwd_overrides(64, 64, 128, 2, (128, 128), (128, 128))
    assert got == ((128, 128), (128, 64))
    assert port_ffa.assemble_bwd_overrides(64, 64, 128, 2, (128, 128), (128, 128)) == dict(
        block_q_dq=128, block_k_dq=128, block_q_dkv=128, block_k_dkv=64,
    )


def test_bwd_plans_follow_params():
    qr, kr, lo, hi = _causal(1000)
    plan, params = port_ffa.plan_params(
        qr, kr, None, lo, hi, 1000, 1000, 128, None, 0.0,
        bwd_overrides=dict(block_q_dq=128, block_k_dq=128),
    )
    dq_plan, dkv_plan = port_ffa.bwd_plans(plan, params, 1000, 1000)
    assert dkv_plan is plan and (dq_plan.block_q, dq_plan.block_k) == (128, 128)
    assert dq_plan.num_work == port_tp.count_ffa_work(qr, kr, lo, hi, 1000, 1000, 128, 128)
    assert params.dq_blocks() == (128, 128) and params.dkv_blocks() == (64, 64)


def test_bwd_model_reads_per_pass_tiles():
    """The backward-mode model prices each pass at its own tiles: a dk/dv
    pass at 128 x 128 has a quarter of the items, each four times the
    area, and the dq pass is untouched."""
    qr, kr, lo, hi = _causal(8192)
    p64 = port_plan.get_ffa_plan(qr, kr, lo, hi, 8192, 8192, 64, 64)
    p128 = port_plan.get_ffa_plan(qr, kr, lo, hi, 8192, 8192, 128, 128)
    same = port_ffa.bwd_shape(p64, 32, 8, 128, 128, 2)
    per_pass = port_ffa.bwd_shape(p64, 32, 8, 128, 128, 2, plan_dkv=p128)
    assert per_pass.dkv_blocks() == (128, 128) and same.dkv_blocks() == (64, 64)
    a, b = port_tp.kernel_ms(same), port_tp.kernel_ms(per_pass)
    assert a["dq"] == b["dq"] and a["dkv"] != b["dkv"]
    assert port_tp.tile_area(per_pass, "dkv") == 4.0 and port_tp.tile_area(per_pass, "dq") == 1.0
