"""The port's padding helpers and reference-named runtime init
(``api/functools.py``, ``api/magi_attn_interface.py``) against the JAX
package's, on the same numpy inputs.

The cases of the JAX package's ``tests/test_api/test_padding_helpers.py``
and ``test_runtime_init_parity.py``: each goes through the JAX function and
the port's counterpart. Ranges, mask types and keys (their plan fields)
must be equal, tensors within float32 1e-5. The pipelines run at cp 1 on
both sides (the port on the CPU, its kernels' plain versions; the JAX
package on a one-device CPU mesh with its ``sdpa`` backend); the padded
mask's pad is the one cp 4 would need, as in the JAX test. The
``*_dispatch`` combos must equal key + ``dispatch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import magiattention_tpu_torch
from magiattention_tpu import api as japi
from magiattention_tpu.common.enum import AttnMaskType as JMaskType
from magiattention_tpu.common.ranges import AttnRanges as JRanges
from magiattention_tpu_torch import api
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

CHUNK = 16
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
# the plan fields both packages' keys carry
KEY_FIELDS = ("q_ranges", "k_ranges", "attn_mask_type", "total_seqlen_q", "total_seqlen_k",
              "chunk_size", "cp_size", "fixed_partitions", "capacities")


def _mesh():
    return Mesh(np.array(jax.devices("cpu")[:1]), axis_names=("cp",))


def _same_key(port_key, jax_key):
    for f in KEY_FIELDS:
        assert getattr(port_key, f) == getattr(jax_key, f), f


def _same_mask(port, jax_):
    (pq, pk, pt), (jq, jk, jt) = port, jax_
    assert pq.to_naive_ranges() == jq.to_naive_ranges()
    assert pk.to_naive_ranges() == jk.to_naive_ranges()
    assert [t.to_int_type() for t in pt] == [t.to_int_type() for t in jt]


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((s, 2, 32), (s, 1, 32), (s, 1, 32))]


def test_infer_varlen_mask_from_batch():
    cu_q, cu_k = api.infer_varlen_mask_from_batch(3, 128)
    assert (cu_q, cu_k) == japi.infer_varlen_mask_from_batch(3, 128)
    assert cu_q == [0, 128, 256, 384]
    assert cu_k == cu_q and cu_k is not cu_q  # independent lists


def test_apply_padding_noop_when_zero():
    qr = AttnRanges.from_ranges([[0, 64]])
    kr = AttnRanges.from_ranges([[0, 64]])
    q2, k2, t2 = api.apply_padding(qr, kr, [AttnMaskType.CAUSAL], 64, 0)
    assert q2 is qr and k2 is kr and t2 == [AttnMaskType.CAUSAL]
    jq, jk, jt = japi.apply_padding(
        JRanges.from_ranges([[0, 64]]), JRanges.from_ranges([[0, 64]]), [JMaskType.CAUSAL], 64, 0
    )
    _same_mask((q2, k2, t2), (jq, jk, jt))


@pytest.mark.parametrize("s, cp, chunk", [(200, 4, 16), (256, 4, 16), (8000, 1, 512), (1, 8, 64)])
def test_compute_pad_size(s, cp, chunk):
    assert api.compute_pad_size(s, cp, chunk) == japi.compute_pad_size(s, cp, chunk)
    assert (s + api.compute_pad_size(s, cp, chunk)) % (cp * chunk) == 0


@pytest.mark.parametrize(
    "qr, kr, types",
    [([[0, 200]], [[0, 200]], ["causal"]),
     ([[0, 90], [90, 200]], [[0, 90], [60, 200]], [0, 3])],
)
def test_apply_padding_matches_jax(qr, kr, types):
    pad = api.compute_pad_size(200, 4, CHUNK)
    got = api.apply_padding(AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
                            [AttnMaskType.normalize(t) for t in types], 200, pad)
    want = japi.apply_padding(JRanges.from_ranges(qr), JRanges.from_ranges(kr),
                              [JMaskType.normalize(t) for t in types], 200, pad)
    _same_mask(got, want)
    assert got[0].to_naive_ranges()[-1] == (200, 256)
    assert got[1].to_naive_ranges()[-1] == (0, 0)


@pytest.mark.parametrize("dim, pad", [(0, 56), (1, 3), (-1, 5), (0, 0)])
def test_pad_unpad_and_squash_match_jax(dim, pad):
    x = np.random.default_rng(3).standard_normal((4, 3, 8)).astype(np.float32)
    got = api.pad_at_dim(torch.from_numpy(x), dim, pad, value=2.0)
    want = japi.pad_at_dim(jnp.asarray(x), dim, pad, value=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = x.shape[dim]
    np.testing.assert_array_equal(
        api.unpad_at_dim(got, dim, n).numpy(), np.asarray(japi.unpad_at_dim(want, dim % 3, n))
    )
    np.testing.assert_array_equal(
        api.squash_batch_dim(got).numpy(), np.asarray(japi.squash_batch_dim(want))
    )


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_mask_matches_jax(causal):
    _same_mask(api.full_attention_mask(100, 120, causal), japi.full_attention_mask(100, 120, causal))


def _jax_pipeline(key, q, k, v):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")
        out_d, _ = japi.calc_attn(
            japi.dispatch(q, key), japi.dispatch(k, key, role="kv"), japi.dispatch(v, key, role="kv"), key
        )
        return np.asarray(japi.undispatch(out_d, key))


def _port_pipeline(key, q, k, v):
    out_d, _ = api.calc_attn(
        api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"), key
    )
    return api.undispatch(out_d, key).numpy()


def test_padded_pipeline_matches_jax():
    """S = 200 padded to 256 (the pad cp 4 at chunk 16 needs), through key
    -> dispatch -> calc_attn -> undispatch on both sides: equal keys, the
    pad rows exactly zero, the unpadded rows within float32 1e-5."""
    s = 200
    pad = api.compute_pad_size(s, 4, CHUNK)
    assert pad == 56
    mask = ([[0, s]], [[0, s]], [AttnMaskType.CAUSAL])
    qr_p, kr_p, types_p = api.apply_padding(
        AttnRanges.from_ranges(mask[0]), AttnRanges.from_ranges(mask[1]), mask[2], s, pad
    )
    ranges = ([list(r) for r in qr_p.to_naive_ranges()], [list(r) for r in kr_p.to_naive_ranges()])
    ints = [t.to_int_type() for t in types_p]
    key = api.magi_attn_flex_key(*ranges, ints, s + pad, s + pad, device="cpu", chunk_size=CHUNK)
    jkey = japi.magi_attn_flex_key(*ranges, ints, s + pad, s + pad, mesh=_mesh(), chunk_size=CHUNK)
    _same_key(key, jkey)
    q, k, v = _inputs(5, s)
    got = _port_pipeline(key, *(api.pad_at_dim(torch.from_numpy(a), 0, pad) for a in (q, k, v)))
    want = _jax_pipeline(jkey, *(japi.pad_at_dim(jnp.asarray(a), 0, pad) for a in (q, k, v)))
    np.testing.assert_array_equal(got[s:], 0.0)
    assert_close(api.unpad_at_dim(torch.from_numpy(got), 0, s).numpy(), want[:s], **TOL)


def test_top_level_exports():
    for name in ("init_dist_attn_runtime_key", "init_dist_attn_runtime_mgr",
                 "magi_attn_flex_dispatch", "magi_attn_varlen_dispatch"):
        assert getattr(magiattention_tpu_torch, name) is getattr(api, name)


def test_key_matches_flex_key():
    """Same mask through both entry points: the same key, equal to JAX's."""
    a = api.init_dist_attn_runtime_key([[0, 256]], [[0, 256]], ["causal"], 256, 256, CHUNK,
                                       device="cpu")
    b = api.magi_attn_flex_key([[0, 256]], [[0, 256]], ["causal"], 256, 256, device="cpu",
                               chunk_size=CHUNK)
    assert a == b and api.get_most_recent_key() is b
    _same_key(a, japi.init_dist_attn_runtime_key(
        [[0, 256]], [[0, 256]], ["causal"], 256, 256, CHUNK, mesh=_mesh()
    ))


def test_mgr_exposes_metas_and_computes():
    mgr = api.init_dist_attn_runtime_mgr([[0, 256]], [[0, 256]], ["causal"], 256, 256, CHUNK,
                                         device="cpu")
    jmgr = japi.init_dist_attn_runtime_mgr([[0, 256]], [[0, 256]], ["causal"], 256, 256, CHUNK,
                                           mesh=_mesh())
    assert mgr.comm_meta is not None and mgr.calc_meta is not None
    assert mgr.dispatch_meta_q.partitions == jmgr.dispatch_meta_q.partitions
    _same_key(mgr.key, jmgr.key)
    q, k, v = _inputs(17, 256)
    got = _port_pipeline(mgr.key, *(torch.from_numpy(a) for a in (q, k, v)))
    want = _jax_pipeline(jmgr.key, *(jnp.asarray(a) for a in (q, k, v)))
    assert_close(got, want, **TOL)


def test_pad_size_applies_padding():
    s0 = 200
    pad = api.compute_pad_size(s0, 4, CHUNK)
    key = api.init_dist_attn_runtime_key([[0, s0]], [[0, s0]], ["causal"], s0, s0, CHUNK,
                                         device="cpu", pad_size=pad)
    jkey = japi.init_dist_attn_runtime_key([[0, s0]], [[0, s0]], ["causal"], s0, s0, CHUNK,
                                           mesh=_mesh(), pad_size=pad)
    _same_key(key, jkey)
    assert key.total_seqlen_q == s0 + pad and key.q_ranges[-1] == (s0, s0 + pad)
    q, k, v = _inputs(23, s0)
    got = _port_pipeline(key, *(api.pad_at_dim(torch.from_numpy(a), 0, pad) for a in (q, k, v)))
    want = _jax_pipeline(jkey, *(japi.pad_at_dim(jnp.asarray(a), 0, pad) for a in (q, k, v)))
    assert_close(got[:s0], want[:s0], **TOL)


@pytest.mark.parametrize("varlen", [False, True], ids=["flex", "varlen"])
def test_dispatch_combos_equal_key_and_dispatch(varlen):
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((256, 2, 8)).astype(np.float32))
    if varlen:
        got, key = api.magi_attn_varlen_dispatch(x, [0, 100, 256], causal=True, device="cpu",
                                                 chunk_size=CHUNK)
        want_key = api.magi_attn_varlen_key([0, 100, 256], causal=True, device="cpu",
                                            chunk_size=CHUNK)
    else:
        got, key = api.magi_attn_flex_dispatch(x, [[0, 256]], [[0, 256]], ["causal"], 256, 256,
                                               device="cpu", chunk_size=CHUNK)
        want_key = api.magi_attn_flex_key([[0, 256]], [[0, 256]], ["causal"], 256, 256,
                                          device="cpu", chunk_size=CHUNK)
    assert key == want_key
    assert torch.equal(got, api.dispatch(x, want_key))
