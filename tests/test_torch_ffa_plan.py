"""The port's FFA plan builder against the JAX package's.

At the JAX package's blocks and extent quanta (8, 128), the port's
``build_ffa_plan`` must give the same six arrays, all 15 meta columns
included; its run offsets must agree with the IS_FIRST/IS_LAST columns.
"""

import numpy as np
import pytest

from magiattention_tpu.kernels.ffa import default_blocks as jax_default_blocks
from magiattention_tpu.kernels.ffa_plan import get_ffa_plan as jax_get_ffa_plan
from magiattention_tpu_torch.kernels.ffa_plan import (
    IS_FIRST,
    IS_LAST,
    build_ffa_plan,
    get_ffa_plan,
)

from tests.torch_port_cases import MASKS

TPU_QUANTA = (8, 128)
BLOCKS = ["jax_default", (16, 32), (64, 64)]


def _blocks(choice, sq, sk):
    return jax_default_blocks(sq, sk) if choice == "jax_default" else choice


@pytest.mark.parametrize("blocks", BLOCKS, ids=str)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plan_arrays_equal_jax(mask, blocks):
    qr, kr, lo, hi, sq, sk = MASKS[mask]
    bq, bk = _blocks(blocks, sq, sk)
    want = jax_get_ffa_plan(qr, kr, lo, hi, sq, sk, bq, bk)
    got = build_ffa_plan(qr, kr, lo, hi, sq, sk, bq, bk, quanta=TPU_QUANTA)
    for name in ("work_qt", "work_kt", "meta", "work_qt_t", "work_kt_t", "meta_t"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.meta.shape[1] == 15
    assert (got.num_q_tiles, got.num_k_tiles) == (want.num_q_tiles, want.num_k_tiles)


@pytest.mark.parametrize("blocks", BLOCKS, ids=str)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_run_offsets_match_first_last_flags(mask, blocks):
    qr, kr, lo, hi, sq, sk = MASKS[mask]
    bq, bk = _blocks(blocks, sq, sk)
    plan = get_ffa_plan(qr, kr, lo, hi, sq, sk, bq, bk)
    for ptr, meta, tiles, n in (
        (plan.run_ptr, plan.meta, plan.work_qt, plan.num_q_tiles),
        (plan.run_ptr_t, plan.meta_t, plan.work_kt_t, plan.num_k_tiles),
    ):
        assert ptr.dtype == np.int32 and len(ptr) == n + 1
        assert ptr[0] == 0 and ptr[-1] == len(meta)
        for t in range(n):
            run = slice(ptr[t], ptr[t + 1])
            assert ptr[t + 1] > ptr[t]
            assert np.all(tiles[run] == t)
            assert meta[ptr[t], IS_FIRST] == 1
            assert meta[ptr[t + 1] - 1, IS_LAST] == 1
            assert meta[run, IS_FIRST].sum() == 1
            assert meta[run, IS_LAST].sum() == 1


def test_plan_cache_reuses_plan_and_device_arrays():
    qr, kr, lo, hi, sq, sk = MASKS["causal"]
    a = get_ffa_plan(qr, kr, lo, hi, sq, sk, 64, 64)
    b = get_ffa_plan(qr.copy(), kr.copy(), lo.copy(), hi.copy(), sq, sk, 64, 64)
    assert a is b
    arrays = a.device_arrays("cpu")
    assert arrays is a.device_arrays("cpu")
    np.testing.assert_array_equal(arrays[2].numpy(), a.run_ptr)
