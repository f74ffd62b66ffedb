"""The port's fault tolerance under random schedules and across the
round pipeline: the random-schedule cases of ``test_faults.py``, the
fault cases of ``test_pipeline_overlap.py`` and ``test_tiered_kv.py``'s
swap handle surviving a recovery, replayed on the port against the
reference (the helpers and the reference cache are
``test_torch_faults.py``'s), and the stale rows a ``page_corruption``
leaves in a reused page, which the port's attention never reads.

The reference's plain decode and verify on the CPU do read them: they
multiply the masked rows' V by a zero probability, and 0 x NaN is NaN.
So where a schedule corrupts a page that a later request reuses, that
request fails in the reference and finishes in the port with the
fault-free tokens (``assert_reference``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import paged_decode_attention as jax_paged_decode  # noqa: E402
from repro_torch.kernels.decode_attention.ops import paged_flash_decode  # noqa: E402
from repro_torch.kernels.verify_attention.ops import paged_flash_verify  # noqa: E402
from repro_torch.serve.engine import STATUS_OK, TERMINAL_STATUSES  # noqa: E402
from repro_torch.serve.faults import FaultSchedule  # noqa: E402
from repro_torch.testing import reused_poisoned_case  # noqa: E402
from test_torch_faults import (  # noqa: E402
    PIPELINES,
    assert_reference,
    assert_survivors,
    one_intra_op_thread,
    port,
    port_engine,
    ref,
    reqs,
)


# ---------------------------------------- the overlap (test_pipeline_overlap.py)
def _pair(spec, fault_args, seed=0, **kw):
    """Serial and pipelined port runs of one schedule against the
    reference's pipelined run: the same figures (``assert_reference``),
    and the serial run's equal the pipelined run's."""
    base = ref(spec, **kw)["tokens"]
    want = ref(spec, fault_args, seed, **kw)
    runs = [port(port_engine(p, **kw), spec, fault_args, seed) for p in (False, True)]
    for got in runs:
        assert_reference(got, want, base, fault_args)
    assert runs[0] == runs[1]
    return runs, want


def test_pipeline_parity_under_faults_with_recovery():
    """NaN quarantine and a kernel fault with step-restart recovery: the
    pipelined run discards its pending round and replays as the serial
    one."""
    (serial, piped), want = _pair(reqs(6, mlo=6, mhi=10),
                                  [dict(kind="nan", step=2, uid=1, span=2),
                                   dict(kind="kernel", step=6)])
    assert piped == want
    assert piped["ledger"][1][0] != STATUS_OK
    assert piped["recoveries"] == 1


def test_pipeline_parity_page_corruption_and_cancel():
    """Corruption at round 2 (seed 9: a page of uid 0) and a cancel of
    uid 2 at round 3, under the per-round audit.  uid 0 fails on its NaN
    logits in both; the reference also fails uid 3, whose growth page is
    uid 0's freed poisoned page, where the port serves it the fault-free
    tokens."""
    (serial, piped), want = _pair(reqs(6), [dict(kind="page_corruption", step=2),
                                            dict(kind="cancel", step=3, uid=2)],
                                  seed=9, audit=True)
    assert piped["ledger"][0][0] == "failed" and piped["ledger"][2][0] == "cancelled"
    assert want["ledger"][3][0] == "failed" and piped["ledger"][3][0] == STATUS_OK


# ------------------------------------------------------- (test_tiered_kv.py)
@PIPELINES
def test_swap_survives_kernel_fault_recovery(pipeline):
    """A swap handle taken before a kernel fault restores into the
    zero-filled pool: it records contents, not page numbers."""
    spec = [dict(uid=0, prompt=list(range(1, 17)), max_new_tokens=16),
            dict(uid=1, prompt=list(range(40, 56)), max_new_tokens=16)]
    kw = dict(num_pages=6, kv_dtype="int8")
    base = ref(spec, preempt="swap", **kw)["tokens"]
    f = [dict(kind="kernel", step=4)]
    want = ref(spec, f, preempt="swap", audit=True, **kw)
    eng = port_engine(pipeline, preempt="swap", audit=True, **kw)
    got = port(eng, spec, f)
    assert got == want and got["tokens"] == base
    assert eng.backend_degraded and eng.last_pool_stats.swap_ins > 0


# -------------------------------------------------- random schedules (property)
def _random_once(eng, spec, base, seed, want=None):
    """One seeded random schedule: the statuses partition the requests,
    every ok request has the fault-free tokens, the pool ends audit-clean
    and drained; with ``want``, every figure is the reference's."""
    fa = [dataclasses.asdict(f) for f in
          FaultSchedule.random(seed, uids=tuple(r["uid"] for r in spec), max_step=16).faults]
    got = port(eng, spec, fa, seed)
    assert got["exc"] is None, fa
    assert set(got["ledger"]) == {r["uid"] for r in spec}
    assert all(v[0] in TERMINAL_STATUSES for v in got["ledger"].values()), fa
    assert_survivors(got, base)
    assert {u for u, v in got["ledger"].items() if v[0] == STATUS_OK} == set(got["tokens"])
    assert got["audit_ok"] and got["used_pages"] == 0, fa
    if want is not None:
        assert_reference(got, want, base, fa)
    return fa


@PIPELINES
def test_random_fault_schedules_parity_smoke(pipeline):
    """Seeds 0-5 over one engine pair (the reference's engine and the
    port's, each degrading where its schedule says), every figure the
    reference's."""
    spec = reqs(4, mlo=4, mhi=8)
    base = ref(spec, max_recoveries=16)["tokens"]
    eng = port_engine(pipeline, max_recoveries=16)
    assert port(eng, spec)["tokens"] == base
    for seed in range(6):
        fa = [dataclasses.asdict(f) for f in FaultSchedule.random(
            seed, uids=tuple(r["uid"] for r in spec), max_step=16).faults]
        _random_once(eng, spec, base, seed, ref(spec, fa, seed, max_recoveries=16))


@pytest.mark.slow
@PIPELINES
def test_random_fault_schedules_parity_sweep(pipeline):
    """The reference's 40-seed sweep on the port: partition, survivors'
    tokens and the audit-clean pool (the reference's own assertions; the
    per-seed figures against the reference are the smoke's)."""
    spec = reqs(5, mlo=5, mhi=9)
    base = ref(spec)["tokens"]
    eng = port_engine(pipeline, max_recoveries=16)
    for seed in range(40):
        _random_once(eng, spec, base, seed)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as hyp_st
except ImportError:     # pragma: no cover
    given = None

if given is not None:
    _PROP = {}

    @settings(max_examples=5, deadline=None, derandomize=True)
    @given(seed=hyp_st.integers(min_value=0, max_value=10_000))
    def test_random_fault_schedule_property(seed):
        """Any seeded schedule over one shared engine pair: the port's
        figures are the reference's (each degrading at the same example),
        survivors keep the fault-free tokens, the pool drains clean.  The
        examples are derandomized, so the gate is the same every run."""
        spec = reqs(4, mlo=4, mhi=8)
        if not _PROP:
            _PROP["base"] = ref(spec)["tokens"]
            _PROP["eng"] = port_engine(max_recoveries=16)
        fa = [dataclasses.asdict(f) for f in FaultSchedule.random(
            seed, uids=tuple(r["uid"] for r in spec), max_step=16).faults]
        _random_once(_PROP["eng"], spec, _PROP["base"], seed,
                     ref(spec, fa, seed, max_recoveries=16))


# ------------------------------------- the stale rows of a reused poisoned page
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("t", [1, 4, 16], ids=["decode", "verify", "verify-long"])
def test_reused_poisoned_page_rows_are_never_read(t, quantized):
    """The new owner of a poisoned page reads only the rows it wrote: the
    plain paged decode (T 1) and verify (T 4, and T 16 = T*G 96, the long
    branch's shape) give finite outputs, bit for bit those with the
    poison replaced by finite garbage.  The reference's plain decode on
    the same page returns NaN: the deviation ``assert_reference`` allows."""
    q, pool, bt, pos = reused_poisoned_case(np.random.default_rng(3), t=t,
                                            quantized=quantized)
    assert any(torch.isnan(v).any() for v in pool.values() if v.is_floating_point())
    clean = {k: torch.nan_to_num(v, nan=7.0) if v.is_floating_point() else v
             for k, v in pool.items()}

    def attend(p):
        scales = {k: p[k] for k in ("k_scales", "v_scales") if k in p}
        if t == 1:
            return paged_flash_decode(q, p["k_pages"], p["v_pages"], bt, pos, **scales)
        return paged_flash_verify(q, p["k_pages"], p["v_pages"], bt, pos, t_window=t,
                                  **scales)

    out = attend(pool)
    assert torch.isfinite(out).all()
    assert torch.equal(out, attend(clean))
    if t == 1 and not quantized:
        b, hkv, g, d = q.shape
        leaked = jax_paged_decode(
            jnp.asarray(q.numpy().reshape(b, 1, hkv * g, d)),
            jnp.asarray(pool["k_pages"].numpy()), jnp.asarray(pool["v_pages"].numpy()),
            jnp.asarray(bt.numpy()), jnp.asarray(pos.numpy()), backend="jnp")
        assert np.isnan(np.asarray(leaked)).any()
