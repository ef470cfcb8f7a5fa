"""The port's Hopper kernel checker (``analysis/kernel_check.py``: K1, K3,
K5) on the CPU.

- K1: every compiled instance's shared memory (the host model) fits a CTA;
  the check against a library's ``<name>_smem_bytes`` passes on the model
  and fails on a figure off by one; each library exports the query with
  the arguments the checker passes (the card's figures: ``chip_smoke.py``
  phases ``tiles_smem`` and ``kernel_audit``). The decode model reproduces
  the figures its sources state.
- K3 and K5 run clean over the corpus, built once for the module (the
  verifier's masks, the window from the JAX package's mask compiler), and
  catch a seeded out-of-range row, page, split and chunk, and an unlisted
  key.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from magiattention_tpu.analysis import kernel_check as jkc
from magiattention_tpu.api.functools import infer_attn_mask_from_cu_seqlens as j_window
from magiattention_tpu_torch.analysis import kernel_check as kc
from magiattention_tpu_torch.analysis.violation import VerifyReport
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.kernels.block_sparse import key_table
from magiattention_tpu_torch.kernels.ffa_plan import KE, QE, FFAPlan, build_ffa_plan
from magiattention_tpu_torch.utils import mem_budget as mb


@pytest.fixture(scope="module")
def corpus():
    return kc.corpus()


@pytest.fixture(scope="module")
def audit(corpus):
    return kc.run_kernel_audit(corpus)


def _errors(report, rule):
    return [v for v in report.errors() if v.rule_id == rule]


def test_audit_runs_clean(audit):
    assert audit.rules_run == ["K1", "K3", "K5"]
    assert audit.ok(), audit.summary()


def test_corpus_is_the_verifiers(corpus):
    """The corpus's window mask is the JAX package's mask compiler's, and it
    holds every rank of each static and dynamic plan."""
    qr, kr, types = j_window([0, kc.SEQ], causal=False, window_size=(64, 0))
    want = ([list(map(int, r)) for r in qr.to_naive_ranges()],
            [list(map(int, r)) for r in kr.to_naive_ranges()],
            [int(t.to_int_type()) for t in types])
    assert kc._masks()["window"] == want
    sites = {c[0].rsplit(" ", 1)[0] for c in corpus.ffa}
    for mask in ("causal", "two_docs", "window"):
        assert f"{mask} cp1 rank0" in sites and f"{mask} cp4 mesh rank3" in sites
        assert f"{mask} cp4 dynamic" in sites
    assert corpus.decode and corpus.nsa


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def test_k1_models_fit_a_cta():
    report = VerifyReport()
    kc.check_k1(report)
    assert report.ok(), report.summary()
    insts = kc.smem_instances()
    assert {i.library for i in insts} == set(kc.LIBRARIES)
    assert all(0 < i.model <= mb.SMEM_PER_CTA for i in insts if i.args[0] in (64, 128, 256)
               and i.library not in kc.FFA_LIBRARIES and not (
                   i.library == "paged_decode_spec" and i.args[1] > 32))
    report = VerifyReport()
    kc.check_k1(report, limit=100_000)
    assert _errors(report, "K1")


def test_k1_library_check_against_a_fake_card():
    models = {(i.library, i.args): i.model for i in kc.smem_instances()}
    query = lambda lib: lambda *args: models[(lib, args)]  # noqa: E731
    report = VerifyReport()
    summary = kc.check_k1_libraries(report, query=query)
    assert report.ok() and summary["checked"] == len(models)
    assert set(summary["compiled"]) == set(kc.LIBRARIES)
    off = lambda lib: lambda *args: models[(lib, args)] + (lib == "paged_decode_int8")  # noqa: E731
    report = VerifyReport()
    kc.check_k1_libraries(report, query=off)
    assert _errors(report, "K1") and all("paged_decode_int8" in v.site for v in _errors(report, "K1"))


@pytest.mark.parametrize("lib", kc.LIBRARIES)
def test_k1_query_is_exported(lib):
    """Each library's source exports ``long <lib>_smem_bytes`` with as many
    int arguments as the checker passes."""
    assert lib in _build.SOURCES
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(rf'extern "C" long {lib}_smem_bytes\(([^)]*)\)', src)
    assert m, lib
    n_args = len([a for a in m.group(1).split(",") if a.strip()])
    assert {len(i.args) for i in kc.smem_instances((lib,))} == {n_args}


def test_decode_model_matches_the_sources():
    """The figures the decode sources state: 73.1 KiB at RMAX 8 with
    float32 pages at d 128, 81.3 and 97.5 at RMAX 16 and 32."""
    kib = [mb.decode_smem_bytes(128, 4, r) / 1024 for r in (8, 16, 32)]
    assert [round(x, 1) for x in kib] == [73.1, 81.2, 97.5]
    assert mb.decode_rmax(9) == 16 and mb.decode_rmax(33) == 0
    assert mb.decode_smem_bytes(96, 4) == 0 == mb.block_sparse_smem_bytes("fwd", 96, 2)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _plan(seq=256, bq=64, bk=64):
    qr = np.array([[0, seq]], np.int32)
    return build_ffa_plan(qr, qr, np.array([-seq], np.int32), np.array([0], np.int32),
                          seq, seq, bq, bk), seq


def _with(plan: FFAPlan, **fields) -> FFAPlan:
    kw = {f: getattr(plan, f) for f in (
        "work_qt", "work_kt", "meta", "work_qt_t", "work_kt_t", "meta_t", "num_q_tiles",
        "num_k_tiles", "block_q", "block_k", "run_ptr", "run_ptr_t")}
    kw.update(fields)
    return FFAPlan(**kw)


def test_k3_catches_a_row_outside_the_grid():
    plan, seq = _plan()
    kt = plan.work_kt.copy()
    kt[-1] = plan.num_k_tiles
    report = VerifyReport()
    kc.check_k3_ffa_plan(report, _with(plan, work_kt=kt), seq, seq)
    assert any("outside the grid" in v.detail for v in _errors(report, "K3"))


def test_k3_catches_a_slice_outside_the_sequence_and_a_broken_transpose():
    plan, seq = _plan()
    meta = plan.meta.copy()
    meta[0, QE] = seq + 64
    report = VerifyReport()
    kc.check_k3_ffa_plan(report, _with(plan, meta=meta), seq, seq)
    details = [v.detail for v in _errors(report, "K3")]
    assert any("outside the sequences" in d for d in details)
    assert any("transposed" in d for d in details)


def test_k3_catches_a_run_without_its_flags():
    plan, seq = _plan()
    meta = plan.meta.copy()
    meta[:, 7] = 0  # IS_LAST
    report = VerifyReport()
    kc.check_k3_ffa_plan(report, _with(plan, meta=meta), seq, seq)
    assert any("IS_LAST" in v.detail for v in _errors(report, "K3"))


def test_k3_clean_plan_and_dummy_tiles():
    """A plan with empty tiles (k rows no slice reaches) passes."""
    qr = np.array([[0, 100]], np.int32)
    kr = np.array([[0, 50]], np.int32)
    plan = build_ffa_plan(qr, kr, np.array([-1000], np.int32), np.array([1000], np.int32),
                          200, 300, 64, 64)
    report = VerifyReport()
    kc.check_k3_ffa_plan(report, plan, 200, 300)
    assert report.ok(), report.summary()
    assert (plan.meta_t[:, KE] == 0).any()  # the dummy items


def test_k3_catches_a_page_outside_the_pool_and_a_gap_in_the_walk(corpus):
    site, table, lengths, pool, ps, splits, split_len = corpus.decode[0]
    report = VerifyReport()
    bad = table.copy()
    bad[0, 0] = pool
    kc.check_k3_decode(report, bad, lengths, pool, ps, splits, split_len)
    assert any("outside the pool" in v.detail for v in _errors(report, "K3"))
    report = VerifyReport()
    kc.check_k3_decode(report, table, lengths, pool, ps, splits, split_len // 2 // 32 * 32 or 32)
    assert any("covers" in v.detail for v in _errors(report, "K3"))


def test_k3_catches_a_chunk_outside_the_keys(corpus):
    site, ctbl, seq, ds = corpus.nsa[0]
    bad = ctbl.copy()
    bad[0, 0, 0] = -(-seq // ds)
    report = VerifyReport()
    kc.check_k3_key_table(report, bad, key_table(torch.from_numpy(ctbl), seq, ds), seq, ds)
    assert any("outside the" in v.detail for v in _errors(report, "K3"))
    # a table built for other entries names the wrong visits
    other = ctbl.copy()
    other[0, 0, :] = (ctbl[0, 0, :].max() + 1) % (seq // ds)
    report = VerifyReport()
    kc.check_k3_key_table(report, ctbl, key_table(torch.from_numpy(other), seq, ds), seq, ds)
    assert any("visits" in v.detail for v in _errors(report, "K3"))


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def test_k5_every_key_the_kernels_read_is_listed_or_proven():
    from magiattention_tpu_torch.env.general import ENV_KEYS_AFFECTING_RUNTIME

    consumed = kc.consumed_env_keys()
    assert "MAGI_ATTENTION_NATIVE_FFA_PLAN" in consumed and "MAGI_ATTENTION_FFA_BLOCK_Q" in consumed
    assert set(consumed) <= set(ENV_KEYS_AFFECTING_RUNTIME) | set(kc.K5_ALLOWLIST)
    # the deterministic mode picks the backward's kernels: it keys the runtime
    det = "MAGI_ATTENTION_DETERMINISTIC_MODE"
    assert det in consumed and det in ENV_KEYS_AFFECTING_RUNTIME and det not in kc.K5_ALLOWLIST
    # the JAX package's allowlist entry, with its proof obligation
    assert set(jkc.K5_ALLOWLIST) <= set(kc.K5_ALLOWLIST)
    assert all(len(proof) > 40 for proof in kc.K5_ALLOWLIST.values())


def test_k5_catches_an_unlisted_key(tmp_path):
    kernels, env = tmp_path / "kernels", tmp_path / "env"
    kernels.mkdir()
    env.mkdir()
    (env / "kernel.py").write_text(
        "import os\n\ndef new_knob():\n    return os.environ.get('MAGI_ATTENTION_SEEDED_KNOB')\n")
    (kernels / "k.py").write_text(
        "from ..env.kernel import new_knob\n\ndef f():\n    return new_knob(), g('MAGI_ATTENTION_LITERAL')\n")
    consumed = kc.consumed_env_keys(Path(kernels), Path(env))
    assert consumed == {"MAGI_ATTENTION_SEEDED_KNOB": {"k.py"}, "MAGI_ATTENTION_LITERAL": {"k.py"}}
    report = VerifyReport()
    kc.check_env_keys(report, consumed=consumed)
    assert len(_errors(report, "K5")) == 2
    report = VerifyReport()
    kc.check_env_keys(report, consumed=consumed, listed=("MAGI_ATTENTION_SEEDED_KNOB",),
                      allowlist={"MAGI_ATTENTION_LITERAL": "proof"})
    assert report.ok()
