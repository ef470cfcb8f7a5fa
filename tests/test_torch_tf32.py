"""The float32 forward's 3xTF32 scheme (``csrc/ffa_fwd_tf32.cuh``), on the CPU.

The body runs only on the card. Pinned here: the operand split the
kernel and ``chip_smoke.py``'s probe share (``tf32_split``: hi with its
low 13 bits zero, rounded to nearest with ties away as ``cvt.rna``, and
hi + lo == x), that the three products it keeps (``scores_3xtf32``) hold
attention at the serving prefill's longest rows within the float32 gate
of a float64 reference, and the shared-memory budget the pack guard
reads for the body.
"""

import numpy as np
import pytest
import torch

from magiattention_tpu_torch.kernels import ffa as port_ffa
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

ATOL = RNORM = 1e-5  # the float32 gates of chip_smoke.py's kernel checks


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 3e20])
def test_split_is_tf32_hi_plus_exact_lo(scale):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)) * scale
    hi, lo = port_ffa.tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert (_bits(hi) & 0x1FFF).eq(0).all()  # 10 mantissa bits
    assert torch.equal(hi + lo, x)  # lo is exact in float32
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()  # round to nearest
    assert torch.equal(port_ffa.tf32_round(hi), hi)


def test_round_is_nearest_with_ties_away():
    """``cvt.rna.tf32.f32``: halfway cases go away from zero."""
    u = 2.0 ** -10  # one tf32 ulp at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 4, 1 + 3 * u / 4, 1 + 3 * u / 2],
                     dtype=torch.float32)
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + u, 1 + 2 * u], dtype=torch.float32)
    assert torch.equal(port_ffa.tf32_round(x), want)


def _attend(s: torch.Tensor, v: torch.Tensor, scale: float):
    """Softmax attention in float64 of scores ``[h, q, k]`` over ``v [k, h,
    d]``: (out ``[q, h, d]``, lse ``[q, h]``)."""
    x = s * scale
    lse = torch.logsumexp(x, dim=-1)
    out = torch.einsum("hqk,khd->qhd", torch.exp(x - lse[..., None]), v)
    return out, lse.T


def test_three_products_hold_the_float32_gate_at_the_longest_rows():
    """The serving prefill's last q tile (64 rows, each over all 2048 live
    keys of its 4096-row table; head_dim 128, 2 of the 8 kv heads with their
    query groups): attention from the three kept products, exact in
    float64, against float64 q k^T, within the float32 gate; one tf32
    product misses it."""
    rng = np.random.default_rng(0)
    hq, hk, d, keys = 8, 2, 128, 2048
    q = torch.from_numpy(rng.standard_normal((64, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((keys, hk, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((keys, hk, d))).repeat_interleave(hq // hk, dim=1)
    scale = d ** -0.5
    s64 = torch.einsum("qhd,khd->hqk", q.double(), k.double().repeat_interleave(hq // hk, dim=1))
    out64, lse64 = _attend(s64, v, scale)
    out3, lse3 = _attend(port_ffa.scores_3xtf32(q, k), v, scale)
    assert (out3 - out64).abs().max() <= ATOL
    assert (lse3 - lse64).abs().max() <= ATOL
    assert (out3 - out64).norm() / out64.norm() <= RNORM
    hi = [port_ffa.tf32_split(t)[0].double() for t in (q, k.repeat_interleave(hq // hk, dim=1))]
    out1, lse1 = _attend(torch.einsum("qhd,khd->hqk", *hi), v, scale)
    assert (lse1 - lse64).abs().max() > ATOL  # one product: ruled out


@pytest.mark.parametrize("d,heads,want", [
    (128, 1, 230_416), (64, 1, 115_728), (64, 2, 148_512), (128, 2, 230_432),
])
def test_float32_forward_budget(d, heads, want):
    """Shared memory of the 3xTF32 body (``Smem`` of csrc/ffa_fwd_tf32.cuh):
    q tiles in hi and lo, the raw K/V chunk and two stages of split tiles,
    one stage where two do not fit (head_dim 128, 2 heads)."""
    got = port_ffa.fwd_pack_smem_bytes(d, heads, 4)
    assert got == want <= port_ffa.SMEM_PER_CTA
    two_stages = d * (512 * heads + 256) + 16 * heads + 1024 + 2 * 512 * d
    assert (got == two_stages) == (two_stages <= port_ffa.SMEM_PER_CTA)
