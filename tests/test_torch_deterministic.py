"""Deterministic mode in the port (ROADMAP C1).

The JAX package's backward is bitwise reproducible by construction
(tests/test_support/test_deterministic.py); the port's fused backward adds
dq with float32 atomics, so the port keeps the guarantee by resolving the
split backward whenever determinism is asked for: by
``flex_flash_attn_func(deterministic=True)`` (carried in ``FFAParams``) or
by MAGI_ATTENTION_DETERMINISTIC_MODE=1 (the original MagiAttention's key),
ahead of a fused pin and of the cost model. On the CPU the routing shows
in which plain versions the backward calls."""

import numpy as np
import pytest
import torch

from magiattention_tpu_torch import api
from magiattention_tpu_torch.env.general import is_deterministic_mode_enable
from magiattention_tpu_torch.functional import flex_flash_attn as ffa_mod
from magiattention_tpu_torch.functional import flex_flash_attn_func
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode, plan_params
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

_DOCS = [[0, 4096], [4096, 8192]]
_PIN_KEYS = (
    "MAGI_ATTENTION_BACKEND_FFA_BWD", "MAGI_ATTENTION_FFA_FUSED_BWD",
    "MAGI_ATTENTION_DETERMINISTIC_MODE",
)


@pytest.fixture
def clean_env(monkeypatch):
    for key in _PIN_KEYS:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_env_key(clean_env):
    assert not is_deterministic_mode_enable()
    clean_env.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", "1")
    assert is_deterministic_mode_enable()
    clean_env.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", "0")
    assert not is_deterministic_mode_enable()


@pytest.mark.parametrize("pin", [None, "fused", "split", "legacy_fused"])
@pytest.mark.parametrize("how", ["none", "argument", "env"])
def test_deterministic_resolves_split_first(clean_env, pin, how):
    """At the train shape the cost model picks fused unpinned; either
    deterministic switch beats it and a fused pin (new or legacy key)."""
    if pin == "legacy_fused":
        clean_env.setenv("MAGI_ATTENTION_FFA_FUSED_BWD", "1")
    elif pin:
        clean_env.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", pin)
    if how == "env":
        clean_env.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", "1")
    plan, params = plan_params(
        _DOCS, _DOCS, [1, 1], None, None, 8192, 8192, 128, None, 0.0,
        deterministic=how == "argument",
    )
    assert params.deterministic == (how == "argument")
    want = "split" if how != "none" or pin == "split" else "fused"
    assert ffa_bwd_mode(plan, params, 128, 128, 2, 32, 8) == want


def test_flex_flash_attn_func_passes_deterministic(clean_env):
    """The argument reaches ``ffa_attn`` (whose CUDA route carries it in
    FFAParams to ``ffa_bwd_mode``); with a sink it reaches the backward on
    the CPU too, which then runs the split plain versions under a fused
    pin."""
    seen = []
    real = ffa_mod.ffa_attn

    def spy(*args, **kw):
        seen.append(kw.get("deterministic"))
        return real(*args, **kw)

    clean_env.setattr(ffa_mod, "ffa_attn", spy)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((64, 2, 64)).astype(np.float32)) for _ in range(3))
    qr = kr = np.array([[0, 64]], np.int32)
    for det in (False, True):
        flex_flash_attn_func(q, k, v, qr, kr, np.array([1]), deterministic=det, backend="ffa")
    assert seen == [False, True]

    clean_env.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
    sink = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    for det, want in ((False, (1, 0)), (True, (0, 1))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, sink)]
        port_ffa.ffa_bwd_fused_plain.calls = port_ffa.ffa_bwd_dq_plain.calls = 0
        out, _ = flex_flash_attn_func(
            *leaves[:3], qr, kr, np.array([1]), sink=leaves[3], deterministic=det, backend="ffa",
        )
        out.sum().backward()
        got = (port_ffa.ffa_bwd_fused_plain.calls, port_ffa.ffa_bwd_dq_plain.calls)
        assert got == want, det


@pytest.mark.parametrize("det_env", [False, True], ids=["fused_pin", "fused_pin_with_env_key"])
def test_env_key_reaches_the_cp_runtime(clean_env, det_env):
    """calc_attn at cp 1 on the CPU (the trainer's attention): the env key
    sends the runtime's backward to the split plain versions under a
    fused pin."""
    clean_env.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
    if det_env:
        clean_env.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", "1")
    docs = [[0, 128], [128, 256]]
    key = api.magi_attn_flex_key(docs, docs, [1, 1], 256, 256, device="cpu")
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((256, 4, 64)).astype(np.float32)).requires_grad_(True)
    k, v = (
        torch.from_numpy(rng.standard_normal((256, 2, 64)).astype(np.float32)).requires_grad_(True)
        for _ in range(2)
    )
    port_ffa.ffa_bwd_fused_plain.calls = port_ffa.ffa_bwd_dq_plain.calls = 0
    port_ffa.ffa_bwd_dkv_plain.calls = 0
    out_d, _ = api.calc_attn(
        api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"), key,
    )
    api.undispatch(out_d, key).sum().backward()
    got = (
        port_ffa.ffa_bwd_fused_plain.calls,
        port_ffa.ffa_bwd_dq_plain.calls,
        port_ffa.ffa_bwd_dkv_plain.calls,
    )
    assert got == ((0, 1, 1) if det_env else (1, 0, 0))
