"""The port's open-loop workload generators (``serve.workload``) against
the reference's: the same (kind, n, seed, params) must give the same
requests byte for byte (arrival times, uids, prompts, budgets,
priorities, deadlines), for every arrival process with shared-prefix and
priority mixtures, the multi-tenant mixture and the census; then the
reference's own property cases (``test_workload.py``) on the port.  Host
only: numpy, no model."""

import numpy as np
import pytest

from repro.serve import workload as jwl
from repro_torch.serve import workload as wl
from repro_torch.serve.engine import Request
from repro_torch.serve.workload import (
    WORKLOAD_KINDS,
    bursty_arrivals,
    describe,
    lognormal_lengths,
    make_tenant_workload,
    make_workload,
    poisson_arrivals,
)

VOCAB = 128


def _flat(timed):
    return [(t.arrival_s, t.request.uid, tuple(t.request.prompt),
             t.request.max_new_tokens, t.request.priority, t.request.deadline_ms,
             t.request.ttft_deadline_ms) for t in timed]


MIXES = {
    "plain": {},
    "prefix": dict(shared_prefix_frac=0.5, n_prefixes=3, prefix_len=8),
    "priority": dict(priority_mix=[(0, 0.2), (1, 0.5), (2, 0.3)]),
    "deadlines": dict(deadline_ms=1234.0, ttft_deadline_ms=99.0, rate=3.0,
                      burst_factor=6.0, mean_dwell=4.0, uid_base=100),
    "all": dict(shared_prefix_frac=0.3, prefix_len=5, priority_mix=[(0, 1.0), (3, 2.0)],
                deadline_ms=50.0, prompt_median=20.0, prompt_sigma=1.0, prompt_max=40,
                out_median=6.0, out_max=12),
}


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("kind", WORKLOAD_KINDS)
def test_make_workload_equals_reference(kind, mix):
    for seed in (0, 7, 31):
        got = make_workload(kind, 40, vocab=VOCAB, seed=seed, **MIXES[mix])
        want = jwl.make_workload(kind, 40, vocab=VOCAB, seed=seed, **MIXES[mix])
        assert _flat(got) == _flat(want)
        assert all(isinstance(t.request, Request) for t in got)
        assert describe(got) == jwl.describe(want)


@pytest.mark.parametrize("kind", WORKLOAD_KINDS)
def test_make_tenant_workload_equals_reference(kind):
    for seed, kw in ((0, {}), (3, dict(n_tenants=6, zipf_s=0.0, system_len=4)),
                     (9, dict(priority_mix=[(0, 0.5), (2, 0.5)], uid_base=50))):
        got, tenants = make_tenant_workload(kind, 30, vocab=VOCAB, seed=seed, **kw)
        want, want_tenants = jwl.make_tenant_workload(kind, 30, vocab=VOCAB, seed=seed, **kw)
        assert _flat(got) == _flat(want) and tenants == want_tenants


def test_arrival_and_length_draws_equal_reference():
    for name, args, kw in (
            ("poisson_arrivals", (50, 4.0), {}),
            ("bursty_arrivals", (50, 4.0), dict(burst_factor=3.0, mean_dwell=2.0)),
            ("lognormal_lengths", (50,), dict(median=9.0, sigma=0.7, lo=2, hi=30))):
        got = getattr(wl, name)(*args, np.random.default_rng(2), **kw)
        want = getattr(jwl, name)(*args, np.random.default_rng(2), **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(wl.zipf_weights(7, 1.1), jwl.zipf_weights(7, 1.1))


def test_validation_matches_reference():
    for fn, args, kw in ((make_workload, ("sinusoidal", 4), dict(vocab=VOCAB)),
                         (make_tenant_workload, ("poisson", 4),
                          dict(vocab=VOCAB, system_len=0)),
                         (poisson_arrivals, (3, 0.0, np.random.default_rng(0)), {}),
                         (bursty_arrivals, (3, 1.0, np.random.default_rng(0)),
                          dict(burst_factor=0.5)),
                         (wl.zipf_weights, (0, 1.0), {})):
        with pytest.raises(ValueError):
            fn(*args, **kw)
    assert describe([]) == jwl.describe([]) == {"n": 0}


# -------------------------------------------- the reference's property cases
def _pflat(timed):
    return [(t.arrival_s, t.request.uid, tuple(t.request.prompt),
             t.request.max_new_tokens, t.request.priority) for t in timed]


@pytest.mark.parametrize("kind", WORKLOAD_KINDS)
def test_deterministic_same_seed(kind):
    a = make_workload(kind, 24, vocab=VOCAB, seed=7, rate=4.0)
    b = make_workload(kind, 24, vocab=VOCAB, seed=7, rate=4.0)
    assert _pflat(a) == _pflat(b)


def test_different_seeds_differ():
    a = make_workload("poisson", 24, vocab=VOCAB, seed=1)
    b = make_workload("poisson", 24, vocab=VOCAB, seed=2)
    assert _pflat(a) != _pflat(b)


def test_closed_arrivals_at_zero():
    w = make_workload("closed", 10, vocab=VOCAB, seed=0)
    assert all(t.arrival_s == 0.0 for t in w)
    assert [t.request.uid for t in w] == list(range(10))


def test_poisson_rate_and_monotonicity():
    arr = poisson_arrivals(4000, 8.0, np.random.default_rng(0))
    assert np.all(np.diff(arr) > 0)
    assert 1 / 8.0 * 0.9 < np.diff(arr).mean() < 1 / 8.0 * 1.1


def test_bursty_is_bimodal():
    arr = bursty_arrivals(4000, 8.0, np.random.default_rng(3), burst_factor=8.0,
                          mean_dwell=16)
    gaps = np.diff(arr)
    assert np.all(gaps > 0)
    lo, hi = np.percentile(gaps, [25, 75])
    assert hi > 5 * lo


def test_lognormal_lengths_clipped():
    lens = lognormal_lengths(2000, np.random.default_rng(1), median=12, sigma=0.8,
                             lo=2, hi=64)
    assert lens.min() >= 2 and lens.max() <= 64
    assert lens.dtype.kind == "i"
    assert (lens == 64).sum() > 0


def test_prompt_and_output_bounds():
    w = make_workload("poisson", 64, vocab=VOCAB, seed=4, prompt_min=3, prompt_max=20,
                      out_min=2, out_max=9)
    for t in w:
        assert 3 <= len(t.request.prompt) <= 20
        assert 2 <= t.request.max_new_tokens <= 9
        assert all(0 <= tok < VOCAB for tok in t.request.prompt)


def test_shared_prefix_mixture():
    w = make_workload("poisson", 80, vocab=VOCAB, seed=5, shared_prefix_frac=0.5,
                      n_prefixes=2, prefix_len=8)
    heads = {}
    for t in w:
        heads.setdefault(tuple(t.request.prompt[:8]), []).append(t.request.uid)
    shared = [uids for uids in heads.values() if len(uids) > 1]
    assert sum(len(u) for u in shared) > 20
    assert all(len(t.request.prompt) > 8 for t in w
               if tuple(t.request.prompt[:8]) in {h for h, u in heads.items() if len(u) > 1})


def test_priority_mix():
    w = make_workload("poisson", 200, vocab=VOCAB, seed=6,
                      priority_mix=[(0, 0.2), (1, 0.5), (2, 0.3)])
    counts = {}
    for t in w:
        counts[t.request.priority] = counts.get(t.request.priority, 0) + 1
    assert set(counts) == {0, 1, 2}
    assert counts[1] > counts[0]


def test_deadlines_plumbed():
    w = make_workload("poisson", 5, vocab=VOCAB, seed=0, deadline_ms=1234.0,
                      ttft_deadline_ms=99.0)
    assert all(t.request.deadline_ms == 1234.0 for t in w)
    assert all(t.request.ttft_deadline_ms == 99.0 for t in w)


def test_describe_census():
    d = describe(make_workload("poisson", 32, vocab=VOCAB, seed=9, rate=4.0))
    assert d["n"] == 32 and d["span_s"] > 0
    assert 0 < d["mean_rate"] < 100
    assert d["priorities"] == {1: 32}


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="kind"):
        make_workload("sinusoidal", 4, vocab=VOCAB)
