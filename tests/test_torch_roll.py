"""The port's ``roll`` (a global roll of dispatched rows) against the JAX
package's.

The host plan (``make_roll_plan``: send rows per ring distance, the
assembly gather, the distances and their capacities) equals the JAX
package's for shifts of one row, of one chunk and past a whole shard,
either way, at cp 2 and 4 over the CP shapes (512 tokens, chunks of 32,
a causal key's dispatch). Over gloo (one spawned run per cp size, a
file-store ``init_method``), ``roll`` of the dispatched rows, undispatched,
and the gradient of ``sum(rolled * g)`` equal the JAX package's ``roll`` on
a CPU mesh of the same size bit for bit in float32: a roll only moves
rows. At cp 1 the rolled sequence is ``numpy.roll``'s.
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu import meta as jax_meta
from magiattention_tpu.common.enum import AttnMaskType as JaxMaskType
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.functional.roll import make_roll_plan as jax_make_roll_plan
from magiattention_tpu_torch import api
from magiattention_tpu_torch import meta as port_meta
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.functional.roll import make_roll_plan, roll_exchange

from tests.torch_port_cases import CP_CHUNK, CP_SEQ, roll_inputs, roll_worker, warm_jax_native


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    """The JAX planners need the JAX package's native library; recover it
    where another process won the race to build it."""
    warm_jax_native()


def _shifts(cp: int) -> list[int]:
    shard = CP_SEQ // cp
    return [1, -1, CP_CHUNK, -CP_CHUNK, shard + 5, -(shard + 5)]


CASES = [(cp, s) for cp in (2, 4) for s in _shifts(cp)]
IDS = [f"cp{cp}-shift{s}" for cp, s in CASES]


def _meta(pkg, ranges, mtype, cp):
    mq, _, _ = pkg.make_dispatch_meta_from_qk_ranges(
        ranges.from_ranges([[0, CP_SEQ]]), ranges.from_ranges([[0, CP_SEQ]]),
        [mtype.CAUSAL], CP_SEQ, CP_SEQ, CP_CHUNK, cp,
    )
    return mq


@pytest.mark.parametrize("cp,shift", CASES, ids=IDS)
def test_roll_plan_equals_jax(cp, shift):
    meta = _meta(port_meta, AttnRanges, AttnMaskType, cp)
    got = make_roll_plan(meta, shift)
    want = jax_make_roll_plan(_meta(jax_meta, JaxRanges, JaxMaskType, cp), shift)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # each rank's exchange takes exactly the rows the assembly reads
    pos = np.asarray(meta.position_ids)
    shard = meta.shard_seqlen
    plans = [roll_exchange(meta, shift, r) for r in range(cp)]
    for r, (plan, asm) in enumerate(plans):
        recv = [pos[s][plans[s][0].send_rows[sum(plans[s][0].send_splits[:r]):][: plan.recv_splits[s]]]
                for s in range(cp)]
        buf = np.concatenate([pos[r], *recv])
        np.testing.assert_array_equal(buf[asm], (pos[r] - shift) % CP_SEQ)
        assert plan.recv_splits[r] == 0 and plan.send_splits[r] == 0


@lru_cache(maxsize=None)
def _port_run(cp: int) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_roll_")
    mp.start_processes(
        roll_worker, args=(cp, os.path.join(out_dir, "init"), out_dir, _shifts(cp)),
        nprocs=cp, start_method="spawn", join=True,
    )
    return out_dir


def _jax_roll(cp: int, shift: int):
    mesh = Mesh(np.array(jax.devices("cpu")[:cp]), axis_names=("cp",))
    key = jax_api.magi_attn_flex_key([[0, CP_SEQ]], [[0, CP_SEQ]], [1], CP_SEQ, CP_SEQ,
                                     mesh=mesh, chunk_size=CP_CHUNK)
    x, g = roll_inputs(abs(shift))

    def f(x):
        return jax_api.undispatch(jax_api.roll(jax_api.dispatch(x, key), key, shift), key)

    out, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("cp,shift", CASES, ids=IDS)
def test_roll_matches_jax_bitwise(cp, shift):
    out_dir = _port_run(cp)
    out, grad = _jax_roll(cp, shift)
    x, g = roll_inputs(abs(shift))
    np.testing.assert_array_equal(out, np.roll(x, shift, axis=0))
    for r in range(cp):
        got = np.load(os.path.join(out_dir, f"roll{shift}_{r}.npz"))
        np.testing.assert_array_equal(got["out"], out)
        np.testing.assert_array_equal(got["grad"], grad)


@pytest.mark.parametrize("shift", [3, -40, 0])
def test_roll_at_cp1_is_numpy_roll(shift):
    key = api.magi_attn_flex_key([[0, 256]], [[0, 256]], [1], 256, 256, device="cpu", chunk_size=32)
    x = torch.arange(256 * 3, dtype=torch.float32).reshape(256, 3).requires_grad_(True)
    out = api.undispatch(api.roll_simple(api.dispatch(x, key), key, shift), key)
    np.testing.assert_array_equal(out.detach().numpy(), np.roll(x.detach().numpy(), shift, axis=0))
    out.backward(torch.ones_like(out))
    assert (x.grad == 1).all()
