"""The port's sampling at temperature > 0 (``repro_torch.serve.sampling``
and the engine's use of it) against the reference.

The PRNG is held to ``jax._src.prng`` and ``jax.random``: threefry2x32,
the keys, ``fold_in``, the random bits and the uniforms bit for bit, and
the Gumbel noise within ``GUMBEL_ATOL`` (the libraries' ``log`` differ
by an ulp).  Tokens drawn from the same logits are equal wherever the
top two scores lie further apart than that tolerance, which each
token-level test asserts first.

The engine's sampled tokens are held to the reference engine's in the
counterparts of the reference's own temperature cases: admission order,
slot count, layout and preemption (requeue and swap) invariance, the
int8 pool, speculation, prefix sharing, the overlapped round, reduced
OLMoE and ``generate``.  Reduced configs in fp32 on the CPU; each
reference engine's tokens are cached at module level."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import sample_token as jax_sample_token  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, sample_token  # noqa: E402
from repro_torch.testing import params_from_numpy  # noqa: E402

ARCH = "qwen2-1.5b"
VOCAB = 512
PAGED = dict(cache_layout="paged", page_size=8)
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This file's engines run many tiny torch ops a step.  On a loaded
    CPU (the suite's parallel workers) intra-op threads wait at every
    op's barrier and a reduced serve takes ~30x longer than on one
    thread, so the module runs on one and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _tkey(jkey) -> torch.Tensor:
    return torch.as_tensor(_u32(jkey))


def _margin(scores: torch.Tensor) -> float:
    """Smallest gap between the top two scores of any row."""
    top = torch.topk(scores, 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


# ---------------------------------------------------------------------------
# the PRNG against jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_threefry2x32_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    x[:, 0] = 0
    x[:, 1] = 0xFFFFFFFF
    want = jax_prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                        jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = sampling.threefry2x32(torch.tensor(int(k[0])), torch.tensor(int(k[1])),
                                torch.as_tensor(_u32(x[0])), torch.as_tensor(_u32(x[1])))
    for w, g in zip(want, got):
        assert np.array_equal(_u32(w), g.numpy())


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 32 + 3])
def test_prng_key_matches_jax(seed):
    assert sampling.prng_key(seed).tolist() == _u32(jax.random.PRNGKey(seed)).tolist()


def test_fold_in_with_uids_and_positions():
    """fold_in(fold_in(key, uid), p), uids as the engine's int32 buffer
    holds them (negative and large ones wrap as the reference's cast),
    batched and one at a time."""
    base = jax.random.PRNGKey(3)
    uids = np.array([0, 1, 7, 2 ** 31 - 1, -3, 123456], np.int32)
    pos = np.array([0, 5, 17, 47, 1, 2 ** 20], np.int32)
    want = np.stack([_u32(jax.random.fold_in(jax.random.fold_in(base, u), p))
                     for u, p in zip(uids, pos)])
    got = sampling.fold_in(sampling.fold_in(sampling.prng_key(3), torch.as_tensor(uids)),
                           torch.as_tensor(pos))
    assert np.array_equal(got.numpy(), want)
    one = sampling.fold_in(_tkey(base), torch.tensor(int(uids[4])))
    assert np.array_equal(one.numpy(), _u32(jax.random.fold_in(base, uids[4])))


@pytest.mark.parametrize("shape", [(512,), (151936,), (1001,), (3, 40)])
def test_random_bits_bit_for_bit(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = _u32(jax.random.bits(key, shape))
    assert np.array_equal(sampling.random_bits(_tkey(key), shape).numpy(), want)


def test_random_bits_batched_keys_are_each_keys_bits():
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(3)]
    got = sampling.random_bits(torch.stack([_tkey(k) for k in keys]), (257,))
    for i, k in enumerate(keys):
        assert np.array_equal(got[i].numpy(), _u32(jax.random.bits(k, (257,))))


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
def test_uniform_bit_for_bit(minval):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(key, (151936,), jnp.float32, minval, 1.0))
    got = sampling.uniform(_tkey(key), (151936,), minval).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="minval"):
        sampling.uniform(_tkey(key), (4,), -2.0)


def test_gumbel_within_tolerance():
    """The port's Gumbel values within GUMBEL_ATOL of -log(-log(u)) in
    float64 on the (bit-exact) uniforms, and of jax.random.gumbel's.
    Against XLA the bound grows by 2^-24 / E, E = -log(u): a log that
    errs by half an ulp of 1 near u = 1 is amplified by the outer log
    (one run of this test read 1.0e-4 at one element; not reproduced)."""
    key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    got = sampling.gumbel(_tkey(key), (151936,)).numpy()
    e = -np.log(sampling.uniform(_tkey(key), (151936,), sampling.F32_TINY).numpy()
                .astype(np.float64))
    assert np.abs(got - (-np.log(e))).max() <= sampling.GUMBEL_ATOL
    want = np.asarray(jax.random.gumbel(key, (151936,), jnp.float32))
    diff = np.abs(got - want)
    worst = int(diff.argmax())
    assert (diff <= sampling.GUMBEL_ATOL + 2.0 ** -24 / e).all(), (
        worst, float(diff[worst]), float(e[worst]))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sample_token_matches_reference(temperature):
    """The reference's ``sample_token`` (one key for the batch, eager):
    equal tokens, the top-two margin above the Gumbel tolerance."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((8, 4096)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax_sample_token(jnp.asarray(logits), key, temperature))
    t = torch.as_tensor(logits)
    scores = (sampling.gumbel(_tkey(key), t.shape)
              + sampling.scale_logits(t, temperature))
    assert _margin(scores) > sampling.GUMBEL_ATOL
    assert np.array_equal(sample_token(t, _tkey(key), temperature).numpy(), want)
    assert np.array_equal(sample_token(t, _tkey(key), 0.0).numpy(), logits.argmax(-1))


@pytest.mark.parametrize("vocab", [512, 151936])
def test_sample_at_matches_reference_engine_eager_and_jitted(vocab):
    """The reference engine's ``sample_at``: eager (its prefill commit)
    divides by T, jitted (its steps) multiplies by f32(1/T); the port's
    ``reciprocal`` flag gives each one's tokens."""
    m = _models()
    eng = JaxServeEngine(m["jm"], m["jp"], max_seq=32, batch_slots=2,
                         temperature=0.7, seed=4)
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, vocab)) * 3).astype(np.float32)
    uids = np.array([0, 1, 2, 9, 9, -5], np.int32)
    pos = np.array([3, 3, 40, 41, 7, 12], np.int32)
    args = (jnp.asarray(logits), jnp.asarray(pos), jnp.asarray(uids))
    eager = np.asarray(eng._sample_at(*args))
    jitted = np.asarray(jax.jit(eng._sample_at)(*args))
    t = torch.as_tensor(logits)
    keys = sampling.fold_in(sampling.fold_in(sampling.prng_key(4), torch.as_tensor(uids)),
                            torch.as_tensor(pos))
    for reciprocal, want in ((False, eager), (True, jitted)):
        scores = (sampling.gumbel(keys, (vocab,))
                  + sampling.scale_logits(t, 0.7, reciprocal))
        assert _margin(scores) > sampling.GUMBEL_ATOL
        got = sampling.sample_at(t, torch.as_tensor(pos), torch.as_tensor(uids),
                                 sampling.prng_key(4), 0.7, reciprocal=reciprocal)
        assert np.array_equal(got.numpy(), want)
        want_scaled = (np.asarray(jax.jit(lambda x: x / 0.7)(logits)) if reciprocal
                       else np.asarray(jnp.asarray(logits) / 0.7))
        got_scaled = sampling.scale_logits(t, 0.7, reciprocal).numpy()
        assert np.array_equal(got_scaled.view(np.int32), want_scaled.view(np.int32))


def test_step_sampler_shares_one_noise_row_per_position():
    """The speculative step's draw: the noise of a window's T positions
    drawn once, row i used by the draft and by the target, gives each
    row's own ``sample_at`` token (the jitted rounding)."""
    base = sampling.prng_key(2)
    sampler = sampling.StepSampler(base, 0.8)
    rng = np.random.default_rng(4)
    b, t, v = 3, 4, 512
    logits = torch.as_tensor((rng.standard_normal((b, t, v)) * 3).astype(np.float32))
    pos = torch.tensor([5, 17, 40], dtype=torch.int32)
    uids = torch.tensor([0, 9, -2], dtype=torch.int32)
    rows = pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32)
    noise = sampler.noise(rows, uids[:, None], v)
    assert noise.shape == (b, t, v)
    got = sampler.draw(noise, logits)
    for i in range(t):
        want = sampling.sample_at(logits[:, i], rows[:, i], uids, base, 0.8, reciprocal=True)
        assert torch.equal(sampler.draw(noise[:, i], logits[:, i]), want)
        assert torch.equal(got[:, i], want)
        assert torch.equal(sampler(logits[:, i], rows[:, i], uids), want)
    with pytest.raises(ValueError, match="temperature"):
        sampling.StepSampler(base, 0.0)


# ---------------------------------------------------------------------------
# the engine: sampled tokens against the reference engine
# ---------------------------------------------------------------------------

def _models(arch=ARCH):
    if arch not in _CACHE:
        jm = JaxModel(jax_reduced_config(arch), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(arch), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(arch),
                               device="cpu")
        _CACHE[arch] = dict(jm=jm, jp=jp, tm=tm, tp=tp)
    return _CACHE[arch]


def _reqs(n=6, seed=5, plo=3, phi=12, mlo=5, mhi=9, prefix=()):
    rng = np.random.default_rng(seed)
    return [(i, list(prefix) + rng.integers(0, VOCAB, int(rng.integers(plo, phi))).tolist(),
             int(rng.integers(mlo, mhi))) for i in range(n)]


def _ref(spec, arch=ARCH, **kw):
    """The reference engine's tokens and preemptions (cached)."""
    kw = {"max_seq": 48, "batch_slots": 2, "temperature": 0.7, "seed": 0, **kw}
    key = (arch, tuple((u, tuple(p), n) for u, p, n in spec), tuple(sorted(kw.items())))
    if key not in _CACHE:
        m = _models(arch)
        eng = JaxServeEngine(m["jm"], m["jp"], **kw)
        _CACHE[key] = (eng.serve([JaxRequest(u, list(p), n) for u, p, n in spec]),
                       eng.preemptions)
    return _CACHE[key]


def _port(spec, arch=ARCH, order=None, **kw):
    kw = {"max_seq": 48, "batch_slots": 2, "temperature": 0.7, "seed": 0, **kw}
    m = _models(arch)
    eng = ServeEngine(m["tm"], m["tp"], **kw)
    reqs = [Request(u, list(p), n) for u, p, n in spec]
    return eng.serve(reqs if order is None else [reqs[i] for i in order]), eng


@pytest.mark.parametrize("kw", [
    dict(),
    dict(batch_slots=3, reverse=True),
    dict(PAGED),
    dict(PAGED, num_pages=5),
    dict(PAGED, num_pages=5, preempt="swap"),
    dict(PAGED, num_pages=5, pipeline=False),
], ids=["dense", "dense-3slots-reversed", "paged", "paged-requeue", "paged-swap",
        "paged-requeue-serial"])
def test_sampled_tokens_match_reference_whatever_order_slots_layout(kw):
    """The reference's test_sampling_reproducible_across_admission_orders:
    the reference's dense tokens at T 0.7, whatever the admission order,
    the slot count, the layout, the preemption policy or the round."""
    spec = _reqs()
    want, _ = _ref(spec)
    kw = dict(kw)
    order = list(range(len(spec)))[::-1] if kw.pop("reverse", False) else None
    got, eng = _port(spec, order=order, **kw)
    assert got == want
    if "num_pages" in kw:
        assert eng.preemptions >= 1
    if kw.get("preempt") == "swap":
        assert eng.last_pool_stats.swap_ins >= 1


def test_sampled_requeue_and_swap_match_reference_paged():
    """Against the reference's own preempting paged engine, under both
    policies: the same tokens and the same preemptions."""
    spec = _reqs()
    for preempt in ("requeue", "swap"):
        kw = dict(PAGED, num_pages=5, preempt=preempt)
        want, want_preempt = _ref(spec, **kw)
        got, eng = _port(spec, **kw)
        assert got == want and eng.preemptions == want_preempt >= 1, preempt


def test_sampling_differs_across_uids_and_seeds():
    """Keys really vary by uid and by seed (not all greedy), and the
    greedy engine differs from the sampled one."""
    spec = [(i, [5, 6, 7, 8], 8) for i in range(4)]
    out, _ = _port(spec, temperature=1.0)
    assert len({tuple(v) for v in out.values()}) > 1
    out2, _ = _port(spec, temperature=1.0, seed=123)
    assert any(out[u] != out2[u] for u in out)
    greedy, _ = _port(spec, temperature=0.0)
    assert len({tuple(v) for v in greedy.values()}) == 1


def test_sampled_int8_pool_matches_reference_int8_engine():
    spec = _reqs()
    kw = dict(PAGED, num_pages=5, batch_slots=3, kv_dtype="int8", preempt="swap")
    want, want_preempt = _ref(spec, **kw)
    got, eng = _port(spec, **kw)
    assert got == want and eng.preemptions == want_preempt >= 1


def test_sampled_spec_decode_matches_reference_nonspec():
    """The reference's test_spec_temperature_matches_nonspec: spec_k 4 at
    T 0.8, seed 7, gives the reference's non-speculative tokens; the
    windows committed more than one token somewhere."""
    spec = _reqs(4, seed=5, mlo=8, mhi=13)
    want, _ = _ref(spec, temperature=0.8, seed=7)
    got, eng = _port(spec, temperature=0.8, seed=7, spec_k=4, draft="self:2", **PAGED)
    assert got == want
    assert all(eng.last_stats[u]["spec_steps"] >= 1 for u, _, _ in spec)


def test_sampled_spec_decode_with_independent_draft_and_swap():
    spec = _reqs(4, seed=5, mlo=8, mhi=13)
    want, _ = _ref(spec, temperature=0.8, seed=7)
    got, eng = _port(spec, temperature=0.8, seed=7, spec_k=3, draft=ARCH,
                     preempt="swap", **dict(PAGED, num_pages=6))
    assert got == want


def test_sampled_prefix_sharing_matches_unshared():
    """The reference's test_shared_temperature_sampling_matches_unshared:
    shared admission changes no sampled token."""
    vocab_prefix = np.random.default_rng(2).integers(0, VOCAB, 16).tolist()
    spec = _reqs(5, seed=4, plo=1, phi=8, prefix=vocab_prefix)
    want, _ = _ref(spec)
    shared, eng = _port(spec, prefix_sharing=True, **PAGED)
    assert shared == want
    assert eng.last_pool_stats.cached_prefix_tokens >= 16
    unshared, _ = _port(spec, **PAGED)
    assert unshared == want


def test_sampled_pipelined_equals_serial():
    """The reference's test_pipeline_parity at T 0.8: both rounds, and
    both equal the reference."""
    spec = _reqs(4, seed=5, mlo=8, mhi=13)
    kw = dict(PAGED, num_pages=6, temperature=0.8, seed=7)
    serial, s_eng = _port(spec, pipeline=False, **kw)
    piped, p_eng = _port(spec, pipeline=True, **kw)
    assert piped == serial == _ref(spec, temperature=0.8, seed=7)[0]
    assert p_eng.preemptions == s_eng.preemptions


def test_sampled_moe_matches_reference():
    """Reduced OLMoE at T 0.7 (requests prefill alone): the reference's
    dense tokens on the port's dense and preempting paged layouts."""
    spec = _reqs(4, seed=2, mlo=8, mhi=13)
    want, _ = _ref(spec, arch="olmoe-1b-7b")
    got, _ = _port(spec, arch="olmoe-1b-7b")
    assert got == want
    paged, eng = _port(spec, arch="olmoe-1b-7b", batch_slots=3, num_pages=6, **PAGED)
    assert paged == want and eng.preemptions >= 1


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    """``generate``: row i samples with uid i, the first token at S; the
    reference's (B, n_tokens), twice on one engine (its buffers reused),
    and on a paged engine too (generate runs dense)."""
    m = _models()
    prompts = np.random.default_rng(1).integers(0, VOCAB, (3, 9)).astype(np.int32)
    jeng = JaxServeEngine(m["jm"], m["jp"], max_seq=48, batch_slots=2,
                          temperature=temperature, seed=3)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 12))
    eng = ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=2,
                      temperature=temperature, seed=3)
    got = eng.generate(prompts, 12)
    assert got.shape == (3, 12) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(eng.generate(prompts, 12).numpy(), want)
    paged = ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=2,
                        temperature=temperature, seed=3, **PAGED)
    assert np.array_equal(paged.generate(torch.as_tensor(prompts), 12).numpy(), want)
    with pytest.raises(ValueError, match="n_tokens"):
        eng.generate(prompts, 0)


def test_serve_lm_runs_on_cpu(capsys):
    from repro_torch import serve_lm

    summary = serve_lm.main(["--device", "cpu", "--layers", "2"])
    out = capsys.readouterr().out
    assert "all requests served" in out
    assert summary["generate_shape"] == (4, 24)
    assert summary["requests"] == 9 and summary["served"] == 9


# ---------------------------------------------------------------------------
# C3: the swap-resume gate under prefix sharing
# ---------------------------------------------------------------------------

def _swap_shared_spec(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, 16).tolist()
    return [(i, prefix + rng.integers(0, VOCAB, int(rng.integers(1, 8))).tolist(),
             int(rng.integers(6, 14))) for i in range(5)]


def _spy_swap_resumes(monkeypatch):
    """Record each swap resume's (needed pages, free pages and available
    pages beyond the live slots' growth pages, admitted)."""
    seen = []
    real = ServeEngine._admit_swapped_row

    def spy(self, st, slot, req):
        need = st.swaps[req.uid].n_blocks
        free = st.mgr.allocator.free - len(st.live)
        avail = st.mgr.available() - len(st.live)
        ok = real(self, st, slot, req)
        seen.append((need, free, avail, ok))
        return ok

    monkeypatch.setattr(ServeEngine, "_admit_swapped_row", spy)
    return seen


def test_c3_swap_with_prefix_sharing_matches_reference(monkeypatch):
    """``preempt='swap'`` with ``prefix_sharing=True`` where both gates
    admit on free pages alone: the reference engine's sampled tokens and
    preemptions."""
    spec = _swap_shared_spec(0)
    kw = dict(PAGED, num_pages=6, preempt="swap", prefix_sharing=True)
    want, want_preempt = _ref(spec, **kw)
    seen = _spy_swap_resumes(monkeypatch)
    got, eng = _port(spec, **kw)
    assert got == want and eng.preemptions == want_preempt >= 1
    admitted = [(need, free) for need, free, _, ok in seen if ok]
    assert admitted and all(free >= need for need, free in admitted)


def test_c3_resume_admitted_by_index_held_pages_is_pinned(monkeypatch):
    """A resume that only index-held pages let in: the port's gate counts
    them (the reference's counts free pages only and keeps the request
    waiting), reclaims them, and serves the tokens of unshared swap
    serving, the reference's among them."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB, 16).tolist()
    spec = [(i, prefix + rng.integers(0, VOCAB, int(rng.integers(8, 17))).tolist(),
             int(rng.integers(10, 20))) for i in range(6)]
    kw = dict(PAGED, max_seq=64, num_pages=9, preempt="swap")
    seen = _spy_swap_resumes(monkeypatch)
    got, eng = _port(spec, prefix_sharing=True, **kw)
    assert any(ok and free < need <= avail for need, free, avail, ok in seen)
    assert eng.last_pool_stats.evictions >= 1
    unshared, _ = _port(spec, **kw)
    assert got == unshared == _ref(spec, **kw)[0]
