"""The port's chunked prefill under a ``prefill_budget`` and its seed loop
(``fused=False``), against the reference engine on the same traces.

Chunked prefill writes a long prompt one bucketed chunk a round through
``Model.prefill_suffix`` while the other slots decode, its row parked in
the step until its last chunk samples the first token: tokens, statuses,
chunk counts and preemptions must be the reference's (its
``test_chunked_prefill_bit_identical`` and
``test_pipeline_parity_chunked_prefill``), and the unchunked run's, under
both ``pipeline`` settings, with preemption (a mid-chunk victim
included), an int8 pool, prefix sharing's budget and sampling.  The seed
loop must give the reference's ``fused=False`` tokens, in ``serve`` and
``generate``.  Reduced qwen2-1.5b in fp32 on the CPU; the helpers and the
reference cache are ``test_torch_scheduling.py``'s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from test_torch_scheduling import (  # noqa: E402
    ARCH,
    PIPELINES,
    assert_partition,
    jax_serve,
    ledger,
    models,
    one_intra_op_thread,
    port_engine,
    port_serve,
    reqs,
)

# test_openloop.py's chunked trace: prompts of 20-39 tokens at max_seq 64,
# 8-token chunks
CHUNKED = dict(max_seq=64, prefill_budget=8, prompt_block=8)
PREFIX = list(range(100, 116))      # two full 8-token pages


def _chunked_spec():
    return reqs(4, seed=7, plo=20, phi=40, mlo=3, mhi=6)


def _mid_chunk_spec():
    """A request decoding on 4-token pages and a 40-token prompt admitted a
    round later in 4-token chunks on a pool with no page to spare: the
    decoder's growth at round 8 preempts the prompt mid-chunk."""
    vocab = reduced_config(ARCH).vocab
    rng = np.random.default_rng(0)
    return [dict(uid=0, prompt=rng.integers(0, vocab, 4).tolist(), max_new_tokens=16),
            dict(uid=1, prompt=rng.integers(0, vocab, 40).tolist(), max_new_tokens=3),
            dict(uid=2, prompt=rng.integers(0, vocab, 5).tolist(), max_new_tokens=12)]


@PIPELINES
def test_chunked_prefill_bit_identical(pipeline):
    """The budget slices the long prompts into per-round chunks; the
    tokens are the unchunked run's and the reference's, and so are the
    chunk counts."""
    spec = _chunked_spec()
    ref, _ = jax_serve(spec, max_seq=64)
    want, want_ledger = jax_serve(spec, **CHUNKED)
    out, eng = port_serve(spec, pipeline, **CHUNKED)
    assert out == ref == want
    assert ledger(eng.last_stats, spec) == want_ledger
    chunks = [eng.last_stats[u]["prefill_chunks"] for u in range(4)]
    assert max(chunks) > 1, "chunked path never engaged"
    assert len(eng.last_stats["timeseries"]["round"]) > 0
    # a chunk logs as a suffix prefill: (uid, its bucket, prompt length)
    logged = [g for g in eng.last_prefill_groups if g[1] == 8 and len(g[0]) == 1]
    assert len(logged) >= sum(c for c in chunks if c > 1)
    assert_partition(eng, spec)


@PIPELINES
def test_pipeline_parity_chunked_prefill(pipeline):
    """The reference's pipeline case: a budget of 8 under the default
    16-token bucket throttles whole prompts a round."""
    spec = reqs(5, plo=9, phi=16)
    want, want_ledger = jax_serve(spec, prefill_budget=8)
    out, eng = port_serve(spec, pipeline, prefill_budget=8)
    assert out == want and ledger(eng.last_stats, spec) == want_ledger


SWAP_CASES = {
    # test_pipeline_overlap.py's swap trace on a 4-page pool, 8-token chunks
    "pool4": (lambda: reqs(6, mlo=6, mhi=12),
              dict(num_pages=4, preempt="swap", prefill_budget=8, prompt_block=8)),
    # the pool that lets a decoder's growth preempt a prompt mid-chunk (a
    # 4-page pool cannot: the admission gate keeps a growth page for each
    # slot, and a prompt of 3 pages is written before any slot grows twice)
    "mid-chunk": (_mid_chunk_spec,
                  dict(page_size=4, num_pages=14, preempt="swap", prefill_budget=4,
                       prompt_block=4)),
}


@pytest.mark.parametrize("case", list(SWAP_CASES))
@PIPELINES
def test_chunked_prefill_under_swap_preemption(case, pipeline):
    """Swap preemption under a budget: the reference's tokens, statuses
    and preemptions, those of the run without the budget, and a mid-chunk
    victim resumes by recompute (no swap-out)."""
    make, kw = SWAP_CASES[case]
    spec = make()
    want, want_ledger = jax_serve(spec, **kw)
    unbudgeted = {k: v for k, v in kw.items() if k not in ("prefill_budget", "prompt_block")}
    eng = port_engine(pipeline, **kw)
    victims = []
    preempt = eng._preempt

    def tap(st, slot):
        held = st.prefilling[slot].req if slot in st.prefilling else st.live[slot]
        victims.append((held.uid, slot in st.prefilling))
        preempt(st, slot)

    eng._preempt = tap
    out = eng.serve([Request(**r) for r in spec])
    assert out == want == port_serve(spec, pipeline, **unbudgeted)[0]
    assert ledger(eng.last_stats, spec) == want_ledger
    assert victims
    if case == "mid-chunk":
        assert (1, True) in victims
        assert eng.last_stats[1].get("swap_outs", 0) == 0
    else:
        assert sum(eng.last_stats[r["uid"]].get("swap_outs", 0) for r in spec) > 0
        assert max(eng.last_stats[r["uid"]].get("prefill_chunks", 0) for r in spec) > 1
    assert_partition(eng, spec)


@PIPELINES
def test_chunked_prefill_int8_pool(pipeline):
    """Chunks quantize on write like a whole prefill's rows: the reference
    int8 engine's tokens under the same budget."""
    spec = _chunked_spec()
    kw = dict(CHUNKED, kv_dtype="int8")
    want, want_ledger = jax_serve(spec, **kw)
    out, eng = port_serve(spec, pipeline, **kw)
    assert out == want and ledger(eng.last_stats, spec) == want_ledger
    assert max(eng.last_stats[u]["prefill_chunks"] for u in range(4)) > 1


@PIPELINES
def test_prefill_budget_with_prefix_sharing(pipeline):
    """Sharing charges the budget by un-cached suffix tokens (no chunking):
    the reference's tokens and admission order, those of the run without
    the budget."""
    spec = reqs(5, prefix=PREFIX, plo=1, phi=9)
    kw = dict(prefix_sharing=True, prefill_budget=8)
    want, want_ledger = jax_serve(spec, **kw)
    out, eng = port_serve(spec, pipeline, **kw)
    assert out == want and ledger(eng.last_stats, spec) == want_ledger
    assert out == port_serve(spec, pipeline, prefix_sharing=True)[0]
    assert eng.last_pool_stats.cached_prefix_tokens > 0


@PIPELINES
def test_chunked_prefill_sampled(pipeline):
    """temperature 0.8: the final chunk samples the first token at
    len(prompt) with the uid's key, so chunking moves no token."""
    spec = _chunked_spec()
    want, _ = jax_serve(spec, temperature=0.8, **CHUNKED)
    out, _ = port_serve(spec, pipeline, temperature=0.8, **CHUNKED)
    assert out == want == jax_serve(spec, temperature=0.8, max_seq=64)[0]


def test_parked_rows_stay_in_place():
    """A mid-chunk row is parked at max_seq - 1 with a huge ``remaining``,
    in place in the engine's step buffers, before every step."""
    eng = port_engine(**CHUNKED)
    dev_pos = None
    seen = []
    park = eng._park_prefilling

    def tap(st):
        nonlocal dev_pos
        park(st)
        dev_pos = dev_pos or st.pos.data_ptr()
        assert st.pos is eng._dev["pos"] and st.pos.data_ptr() == dev_pos
        for slot in st.prefilling:
            seen.append(slot)
            assert int(st.pos[slot]) == 63 and int(st.remaining[slot]) == 1 << 30

    eng._park_prefilling = tap
    eng.serve([Request(**r) for r in _chunked_spec()])
    assert seen


# ---------------------------------------------------------------- the seed loop
SEED_SPEC = dict(n=6)


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
@PIPELINES
def test_seed_loop_matches_reference(temperature, pipeline):
    """fused=False on the dense layout: each admitted request prefills
    alone, each step is eager over the whole cache; the reference's
    fused=False tokens, and the fused engine's."""
    spec = reqs(**SEED_SPEC)
    kw = dict(cache_layout="dense", fused=False, temperature=temperature)
    want, want_ledger = jax_serve(spec, **kw)
    out, eng = port_serve(spec, pipeline, **kw)
    assert out == want and ledger(eng.last_stats, spec) == want_ledger
    assert all(len(uids) == 1 for uids, _, _ in eng.last_prefill_groups)
    assert eng.last_graph_stats["graphs"] == 0
    fused, _ = port_serve(spec, pipeline, cache_layout="dense", temperature=temperature)
    assert out == fused


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_seed_loop_generate(temperature):
    m = models()
    prompts = np.random.default_rng(4).integers(0, reduced_config(ARCH).vocab, (3, 7))
    ref = JaxServeEngine(m["jm"], m["jp"], max_seq=48, batch_slots=3,
                         temperature=temperature, seed=0, fused=False)
    want = np.asarray(ref.generate(jnp.asarray(prompts, jnp.int32), 6))
    eng = ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=3,
                      temperature=temperature, seed=0, fused=False)
    got = eng.generate(prompts, 6)
    assert np.array_equal(got.numpy(), want)
