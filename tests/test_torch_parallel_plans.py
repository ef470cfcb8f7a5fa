"""The port's host planning for the CP baselines against the JAX package's
``parallel/_utils.py``.

Each process of the port builds only its own rank's plans; the JAX
package builds every rank's and stacks them. Held, for every (step,
rank): the zigzag permutations; the clipped slices of the contiguous and
zigzag rings (cp 2, 4, 8), of LoongTrain's double ring (its ``src_of``,
(O, I) in (2, 2) and (4, 2), both shardings), of HybridCP and of the
AllGather variants, array-equal to the slices JAX's helpers clip for the
same pair; and the plans built from them field-equal to JAX's at the
same (64, 64) tiles (the port rounds the live-extent columns to (1, 1),
JAX to its (8, 128): compared after rounding the port's). Also the zigzag
area balance, the odd-shard error, and a one-rank mesh.
"""

import numpy as np
import pytest
import torch

from magiattention_tpu.parallel import _utils as jax_utils
from magiattention_tpu_torch.kernels.ffa_plan import EK0, EK1, EQ0, EQ1
from magiattention_tpu_torch.meta.container.slice import band_area_batch
from magiattention_tpu_torch.parallel import ProcessMesh, _utils, local_shard
from magiattention_tpu_torch.parallel.hybrid import hybrid_rank_plans
from magiattention_tpu_torch.parallel.loongtrain import loongtrain_rank_plans, src_of
from magiattention_tpu_torch.parallel.ring import allgather_rank_plan, ring_rank_plans

from tests.torch_port_cases import BASE_MASKS

S = 256
TILES = (64, 64)
TPU_QUANTA = (8, 128)
MASKS = {
    **BASE_MASKS,
    # inverse-causal and bi-causal slices, off-diagonal
    "mixed": ([[0, 128], [128, 256], [128, 256]], [[0, 128], [0, 128], [128, 256]], [2, 3, 1]),
}
PLAN_FIELDS = ("work_qt", "work_kt", "meta", "work_qt_t", "work_kt_t", "meta_t")
GRIDS = [(2, 2), (4, 2)]


def _meta(mask):
    qr, kr, tm = MASKS[mask]
    return _utils.band_meta(qr, kr, tm), jax_utils.band_meta(np.array(qr), np.array(kr), np.array(tm))


def _to_tpu_quanta(meta: np.ndarray, bq: int, bk: int) -> np.ndarray:
    """The port's exact live extents rounded as the JAX package rounds them."""
    m = meta.copy()
    qq, kq = TPU_QUANTA
    m[:, EQ0] = m[:, EQ0] // qq * qq
    m[:, EQ1] = np.minimum(-(-m[:, EQ1] // qq) * qq, bq)
    m[:, EK0] = m[:, EK0] // kq * kq
    m[:, EK1] = np.minimum(-(-m[:, EK1] // kq) * kq, bk)
    return m


def _same_plan(port, ref, what: str) -> None:
    assert (port.num_q_tiles, port.num_k_tiles) == (ref.num_q_tiles, ref.num_k_tiles), what
    for f in PLAN_FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        if f.startswith("meta"):
            a = _to_tpu_quanta(a, port.block_q, port.block_k)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what} {f}"


@pytest.mark.parametrize("S_,cp", [(256, 4), (256, 8), (96, 3), (64, 1), (40, 2)])
def test_zigzag_perms_match_jax(S_, cp):
    perm = _utils.zigzag_perm(S_, cp)
    np.testing.assert_array_equal(perm, jax_utils.zigzag_perm(S_, cp))
    np.testing.assert_array_equal(_utils.zigzag_inv_perm(S_, cp), jax_utils.zigzag_inv_perm(S_, cp))
    np.testing.assert_array_equal(perm[_utils.zigzag_inv_perm(S_, cp)], np.arange(S_))


@pytest.mark.parametrize("cp", [2, 4, 8])
@pytest.mark.parametrize("sharding", ["contig", "zigzag"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ring_slices_and_plans_match_jax(mask, sharding, cp):
    (qr, kr, lo, hi), (jqr, jkr, jlo, jhi) = _meta(mask)
    shard = S // cp
    if sharding == "zigzag":
        c = shard // 2
        slices = _utils.zigzag_ring_step_slices
        ref_plans = jax_utils.zigzag_ring_step_plans(jqr, jkr, jlo, jhi, shard, cp, *TILES)

        def ref_slices(r, src):
            return jax_utils.clip_to_segs(jqr, jkr, jlo, jhi, jax_utils.zigzag_segs(r, cp, c),
                                          jax_utils.zigzag_segs(src, cp, c))
    else:
        slices = _utils.ring_step_slices
        ref_plans = jax_utils.ring_step_plans(jqr, jkr, jlo, jhi, shard, cp, *TILES)

        def ref_slices(r, src):
            return jax_utils.clip_to_blocks(jqr, jkr, jlo, jhi, r * shard, (r + 1) * shard,
                                            src * shard, (src + 1) * shard)
    for r in range(cp):
        got = slices(qr, kr, lo, hi, shard, cp, r)
        plans = ring_rank_plans(*MASKS[mask], S, cp, r, sharding)
        assert len(got) == len(plans) == cp
        for s in range(cp):
            np.testing.assert_array_equal(got[s], ref_slices(r, (r - s) % cp), err_msg=f"r{r} s{s}")
            _same_plan(plans[s], ref_plans[s][r], f"{mask} {sharding} cp{cp} r{r} s{s}")


@pytest.mark.parametrize("outer,inner", GRIDS)
@pytest.mark.parametrize("sharding", ["contig", "zigzag"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_double_ring_slices_and_plans_match_jax(mask, sharding, outer, inner):
    """LoongTrain's double ring: the kv visiting ring rank b at step t is
    ring rank ``src_of(b, t)``'s, clipped as JAX clips it."""
    (qr, kr, lo, hi), (jqr, jkr, jlo, jhi) = _meta(mask)
    R = outer * inner
    shard, c = S // R, S // R // 2
    src = src_of(outer, inner)
    ref_plans = (
        jax_utils.zigzag_ring_step_plans(jqr, jkr, jlo, jhi, shard, R, *TILES, ring_rank_of=src)
        if sharding == "zigzag" else None
    )
    for b in range(R):
        fn = _utils.zigzag_ring_step_slices if sharding == "zigzag" else _utils.ring_step_slices
        got = fn(qr, kr, lo, hi, shard, R, b, ring_rank_of=src)
        plans = loongtrain_rank_plans(*MASKS[mask], S, outer, inner, b, sharding)
        for t in range(R):
            if sharding == "zigzag":
                want = jax_utils.clip_to_segs(jqr, jkr, jlo, jhi, jax_utils.zigzag_segs(b, R, c),
                                              jax_utils.zigzag_segs(src(b, t), R, c))
                ref = ref_plans[t][b]
            else:
                want = jax_utils.clip_to_blocks(jqr, jkr, jlo, jhi, b * shard, (b + 1) * shard,
                                                src(b, t) * shard, (src(b, t) + 1) * shard)
                ref = jax_utils.block_plan(want, shard, shard, *TILES)
            np.testing.assert_array_equal(got[t], want, err_msg=f"b{b} t{t}")
            _same_plan(plans[t], ref, f"{mask} {sharding} O{outer} I{inner} b{b} t{t}")


@pytest.mark.parametrize("outer,inner", GRIDS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_hybrid_slices_and_plans_match_jax(mask, outer, inner):
    (qr, kr, lo, hi), (jqr, jkr, jlo, jhi) = _meta(mask)
    shard, sup = S // (outer * inner), S // outer
    for b in range(outer * inner):
        got = _utils.hybrid_step_slices(qr, kr, lo, hi, S, outer, inner, b)
        plans = hybrid_rank_plans(*MASKS[mask], S, outer, inner, b)
        for o in range(outer):
            src = (b // inner - o) % outer
            want = jax_utils.clip_to_blocks(jqr, jkr, jlo, jhi, b * shard, (b + 1) * shard,
                                            src * sup, (src + 1) * sup)
            np.testing.assert_array_equal(got[o], want, err_msg=f"b{b} o{o}")
            _same_plan(plans[o], jax_utils.block_plan(want, shard, sup, *TILES),
                       f"{mask} O{outer} I{inner} b{b} o{o}")


@pytest.mark.parametrize("cp", [2, 4, 8])
@pytest.mark.parametrize("sharding", ["contig", "zigzag"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_allgather_plans_match_jax(mask, sharding, cp):
    _, (jqr, jkr, jlo, jhi) = _meta(mask)
    shard = S // cp
    for r in range(cp):
        segs = (jax_utils.zigzag_segs(r, cp, shard // 2) if sharding == "zigzag"
                else [(r * shard, (r + 1) * shard, 0)])
        want = jax_utils.block_plan(jax_utils.clip_to_segs(jqr, jkr, jlo, jhi, segs, [(0, S, 0)]),
                                    shard, S, *TILES)
        _same_plan(allgather_rank_plan(*MASKS[mask], S, cp, r, sharding), want,
                   f"{mask} {sharding} cp{cp} r{r}")


def _rank_areas(sharding: str, cp: int) -> list[int]:
    qr, kr, lo, hi = _utils.band_meta(*MASKS["causal"])
    slices = _utils.zigzag_ring_step_slices if sharding == "zigzag" else _utils.ring_step_slices
    return [
        int(sum(band_area_batch(*(sl[:, i] for i in range(6))).sum()
                for sl in slices(qr, kr, lo, hi, S // cp, cp, r)))
        for r in range(cp)
    ]


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_zigzag_balances_causal_area(cp):
    """Zigzag gives every rank the same causal area; contiguous blocks
    give rank r (2r + 1) / 2 blocks' squares."""
    zig = _rank_areas("zigzag", cp)
    assert len(set(zig)) == 1 and sum(zig) == S * (S + 1) // 2
    contig = _rank_areas("contig", cp)
    block = (S // cp) ** 2
    assert sum(contig) == sum(zig)
    assert [round(a / block * 2) for a in contig] == [2 * r + 1 for r in range(cp)]


def test_odd_shard_raises():
    qr, kr, lo, hi = _utils.band_meta(*MASKS["causal"])
    with pytest.raises(ValueError, match="even per-rank shard"):
        _utils.zigzag_ring_step_slices(qr, kr, lo, hi, 33, 2, 0)
    with pytest.raises(ValueError, match="even per-rank shard"):
        allgather_rank_plan(*MASKS["causal"], 132, 4, 0, "zigzag")
    with pytest.raises(ValueError, match="seqlen % "):
        _utils.zigzag_perm(132, 4)
    with pytest.raises(ValueError, match="unknown ring sharding"):
        ring_rank_plans(*MASKS["causal"], S, 4, 0, "striped")


def test_one_rank_mesh():
    """A mesh of one rank needs no process group (the cp 1 case)."""
    mesh = ProcessMesh(np.zeros((1, 1), np.int64), ("rp", "sp"))
    assert mesh.shape == {"rp": 1, "sp": 1} and mesh.group("rp") is None
    assert mesh.index(("rp", "sp")) == 0 and mesh.line("sp") == [0]
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(local_shard(x, mesh, ("rp", "sp")), x)
    with pytest.raises(ValueError, match="not in the mesh"):
        ProcessMesh(np.array([1]), ("cp",))
