"""The port's ``utils/sparse_utils.py`` against the JAX package's on the
same numpy inputs: every function, over block masks (random, the Magi-1
video pattern causal and not, empty and full rows), top-k tables with
-1 padding and repeats, and varlen block boundaries. Masks and tables are
held array-equal, range lists range-equal (the same ``(start, end)``
pairs in the same order) and mask types equal (all FULL)."""

import numpy as np
import pytest

from magiattention_tpu.utils import sparse_utils as jax_su
from magiattention_tpu_torch.utils import sparse_utils as port_su
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)


def _block_masks():
    rng = np.random.default_rng(0)
    masks = {
        "random": rng.random((6, 9)) < 0.4,
        "dense_random": rng.random((5, 5)) < 0.8,
        "video_causal": jax_su.make_video_block_mask(4, 2, window_frames=2),
        "video_bidirectional": jax_su.make_video_block_mask(5, 1, 3, causal_frames=False),
        "empty_rows": np.zeros((3, 4), dtype=bool),
        "full": np.ones((3, 4), dtype=bool),
    }
    masks["empty_rows"][1, 1:3] = True
    return masks


BLOCK_MASKS = _block_masks()


def _same_ranges(port, ref):
    """Range lists and mask types of both packages equal."""
    for a, b in zip(port[:2], ref[:2]):
        assert a.to_naive_ranges() == b.to_naive_ranges()
    assert [t.to_int_type() for t in port[2]] == [t.to_int_type() for t in ref[2]]


@pytest.mark.parametrize("name", sorted(BLOCK_MASKS))
@pytest.mark.parametrize("bq,bk", [(16, 16), (8, 32)])
def test_block_mask_to_ranges_and_back(name, bq, bk):
    bm = BLOCK_MASKS[name]
    port = port_su.block_mask_to_ranges(bm, bq, bk)
    _same_ranges(port, jax_su.block_mask_to_ranges(bm, bq, bk))
    nqb, nkb = bm.shape
    back = port_su.ranges_to_block_mask(port[0], port[1], nqb, nkb, bq, bk)
    np.testing.assert_array_equal(
        back, jax_su.ranges_to_block_mask(port[0], port[1], nqb, nkb, bq, bk))
    np.testing.assert_array_equal(back, bm)
    np.testing.assert_array_equal(port_su.block_mask_to_dense_mask(bm, bq, bk),
                                  jax_su.block_mask_to_dense_mask(bm, bq, bk))


@pytest.mark.parametrize("frames,blocks,window,causal",
                         [(4, 1, 2, True), (6, 3, 1, True), (5, 2, 3, False), (3, 2, 8, True)])
def test_make_video_block_mask(frames, blocks, window, causal):
    np.testing.assert_array_equal(
        port_su.make_video_block_mask(frames, blocks, window, causal),
        jax_su.make_video_block_mask(frames, blocks, window, causal),
    )


TOPK = {
    "padded": np.array([[0, 3, -1], [2, -1, -1], [4, 1, 0], [-1, -1, -1]]),
    "repeats": np.array([[1, 1, 5], [0, 5, 5]]),
    "random": np.random.default_rng(1).integers(-1, 8, (7, 4)),
}


@pytest.mark.parametrize("name", sorted(TOPK))
def test_topk_indices(name):
    idx = TOPK[name]
    nkb = 8
    np.testing.assert_array_equal(port_su.topk_indices_to_block_mask(idx, nkb),
                                  jax_su.topk_indices_to_block_mask(idx, nkb))
    _same_ranges(port_su.topk_indices_to_ranges(idx, 16, 32, nkb),
                 jax_su.topk_indices_to_ranges(idx, 16, 32, nkb))


@pytest.mark.parametrize("name", ["random", "video_causal", "empty_rows"])
def test_varlen_block_mask_to_ranges(name):
    bm = BLOCK_MASKS[name]
    rng = np.random.default_rng(2)
    qb = np.concatenate([[0], np.cumsum(rng.integers(1, 40, bm.shape[0]))])
    kb = np.concatenate([[0], np.cumsum(rng.integers(1, 40, bm.shape[1]))])
    _same_ranges(port_su.varlen_block_mask_to_ranges(bm, qb, kb),
                 jax_su.varlen_block_mask_to_ranges(bm, qb, kb))
