"""RWKV6-7B (``family="ssm"``) and Zamba2-2.7B (``family="hybrid"``)
serving (ROADMAP A14c) in the port against the reference on the CPU.

Reduced configs as the reference's (RWKV6: 4 layers, d_model 256, no
attention heads, head size 32; Zamba2: 12 Mamba2 layers in 2 groups of 6
behind one shared attention block of 4 heads of 64, state 16, head dim
32), fp32, the reference's weights carried over by ``params_from_numpy``.
The cases:
- the configs and the parameter leaves;
- each mixer (RWKV6's time and channel mix, Mamba2's causal conv and SSD
  mix) against its JAX counterpart, continuing from a random state;
- ``forward`` logits, ``prefill`` logits and every cache leaf, and
  teacher-forced decode against ``forward`` (the counterparts of
  ``tests/test_arch_smoke.py:90`` and ``tests/test_train_serve.py:140``);
- ``ServeEngine`` greedy tokens on the dense layout (fused, seed loop,
  requeued after a kernel fault) and ``generate`` against the reference
  engine's; the paged layout and a hybrid self-draft refused as the
  reference refuses them;
- qwen2 speculating with a recurrent draft: tokens and accept counts
  against the reference's spec engine on the same draft weights, and the
  reference's draft-state behaviour pinned (prefilled through the prompt
  bucket's padding, advanced by the whole window, never rolled back);
- the serving CLI; the plain attention versions at head dim 80 (Zamba2's
  full heads) against the reference's ``ref.py``."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.decode_attention import ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention import ref as jax_flash_ref  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve import spec_decode as jax_spec_decode  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.faults import Fault as JaxFault  # noqa: E402
from repro.serve.faults import FaultSchedule as JaxFaultSchedule  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.decode_attention.ops import flash_decode  # noqa: E402
from repro_torch.kernels.decode_attention.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import recurrent  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import Fault, FaultSchedule  # noqa: E402
from repro_torch.serve.spec_decode import make_self_draft, resolve_draft  # noqa: E402
from repro_torch.serve.step_graph import StepGraphs  # noqa: E402
from repro_torch.testing import expected_leaves, leaf_paths, params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The scans are many small torch ops; one intra-op thread keeps them
    fast on a loaded CPU (as ``test_torch_mla.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("rwkv6-7b", "zamba2-2.7b")
TARGET = "qwen2-1.5b"
# fp32 throughout: a mixer and the logits through 4 / 12 layers (XLA and
# PyTorch order their sums differently), and the reference's own
# decode-vs-forward tolerances (test_arch_smoke.py:90, test_train_serve.py:140)
MIX_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
PREFILL_DECODE_TOL = dict(rtol=5e-3, atol=5e-3)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE = dict(max_seq=48, batch_slots=2)
SPEC = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8, spec_k=4)
_CACHE = {}


# The reference runs jitted wherever a test only reads its results (init,
# forward, prefill, the mixers, the attention oracles): one compile a
# function, where eagerly each operation of each shape compiles on its own.

def _models(arch):
    """(reference model, its params, port params) of a reduced config."""
    if arch not in _CACHE:
        jm = JaxModel(jax_reduced_config(arch), compute_dtype=jnp.float32, remat=False)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(arch),
                               device="cpu")
        _CACHE[arch] = (jm, jp, tp)
    return _CACHE[arch]


def _port(arch, **kw):
    return Model(reduced_config(arch), device="cpu", dtype=torch.float32, **kw)


def _tokens(b=2, s=9, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _jax_forward(arch):
    key = ("forward", arch)
    if key not in _CACHE:
        jm, jp, _ = _models(arch)
        _CACHE[key] = np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(_tokens())}))
    return _CACHE[key]


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# configs and leaves
# ---------------------------------------------------------------------------

FIELDS = ("family", "attn_type", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_head", "d_ff", "vocab", "rwkv_head_size", "ssm_state", "ssm_expand",
          "ssm_head_dim", "ssm_conv", "hybrid_attn_every")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_leaves_follow_reference(arch):
    """Full and reduced configs carry the reference's fields (RWKV6's
    reduced config has no heads: d_head 256), and the port's own init
    makes the reference's leaves and shapes."""
    for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
        c, jc = get(arch), jget(arch)
        for f in FIELDS:
            assert getattr(c, f) == getattr(jc, f), (get.__name__, f)
    if arch == "rwkv6-7b":
        assert reduced_config(arch).n_heads == 0 and reduced_config(arch).d_head == 256
    else:
        assert reduced_config(arch).n_layers == 12
    _, jp, _ = _models(arch)
    mine = _port(arch).init(torch.Generator().manual_seed(0))
    assert leaf_paths(mine) == leaf_paths(jp) == list(expected_leaves(reduced_config(arch)))

    def leaf(tree, path):
        for part in path.split("."):
            tree = tree[part]
        return tree

    for path in leaf_paths(mine):
        assert tuple(leaf(mine, path).shape) == tuple(leaf(jp, path).shape), path


def test_other_families_still_refused():
    for family in ("encdec", "vlm"):
        with pytest.raises(NotImplementedError, match="A14d"):
            Model(dataclasses.replace(reduced_config(TARGET), family=family), device="cpu")
    with pytest.raises(ValueError, match="no attention"):
        Model(dataclasses.replace(reduced_config("rwkv6-7b"), attn_type="gqa"),
              device="cpu")


# ---------------------------------------------------------------------------
# the mixers, each from a random state
# ---------------------------------------------------------------------------

def _mixer_case(name):
    """(JAX output tree, port output tree) of one mixer at the reduced
    config, with the first layer's weights of the reference's model init
    and a random incoming state."""
    rng = np.random.default_rng(5)
    b, s = 2, 7
    arch, leaf = (("rwkv6-7b", "tm") if name in ("time_mix", "channel_mix")
                  else ("zamba2-2.7b", "mamba"))
    cfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax.tree.map(lambda a: a[0], _models(arch)[1]["layers"][leaf])
    tp = {k: _tensor(v) for k, v in jp.items()}
    d = cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    if name == "time_mix":
        hs = cfg.rwkv_head_size
        shift = rng.standard_normal((b, d)).astype(np.float32)
        wkv = rng.standard_normal((b, d // hs, hs, hs)).astype(np.float32)
        want = jax.jit(functools.partial(jax_recurrent.rwkv6_time_mix, cfg=cfg))(
            jp, jnp.asarray(x), state=(jnp.asarray(shift), jnp.asarray(wkv)))
        got = recurrent.rwkv6_time_mix(tp, _tensor(x), tcfg, (_tensor(shift), _tensor(wkv)))
    elif name == "channel_mix":
        shift = rng.standard_normal((b, d)).astype(np.float32)
        want = jax.jit(functools.partial(jax_recurrent.rwkv6_channel_mix, cfg=cfg))(
            jp, jnp.asarray(x), shift=jnp.asarray(shift))
        got = recurrent.rwkv6_channel_mix(tp, _tensor(x), tcfg, _tensor(shift))
    elif name == "causal_conv":
        c = cfg.ssm_expand * d + 2 * cfg.ssm_state
        xc = rng.standard_normal((b, s, c)).astype(np.float32)
        st = rng.standard_normal((b, cfg.ssm_conv - 1, c)).astype(np.float32)
        want = jax.jit(jax_recurrent._causal_conv)(
            jnp.asarray(xc), jnp.asarray(jp["conv_w"]), jnp.asarray(jp["conv_b"]) + 0.1,
            jnp.asarray(st))
        got = recurrent.causal_conv(_tensor(xc), tp["conv_w"], tp["conv_b"] + 0.1,
                                    _tensor(st))
    else:
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        conv = rng.standard_normal((b, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state))
        ssm = rng.standard_normal((b, nh, cfg.ssm_head_dim, cfg.ssm_state))
        conv, ssm = conv.astype(np.float32), ssm.astype(np.float32)
        want = jax.jit(functools.partial(jax_recurrent.mamba2_mix, cfg=cfg))(
            jp, jnp.asarray(x), state=(jnp.asarray(conv), jnp.asarray(ssm)))
        got = recurrent.mamba2_mix(tp, _tensor(x), tcfg, (_tensor(conv), _tensor(ssm)))
    return jax.tree.leaves(want), jax.tree.leaves(got)


@pytest.mark.parametrize("name", ["time_mix", "channel_mix", "causal_conv", "mamba2_mix"])
def test_mixer_matches_reference_from_a_state(name):
    want, got = _mixer_case(name)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MIX_TOL)


def test_states_stay_fp32_under_bf16():
    """bf16 activations keep fp32 wkv and SSD states, as the reference's."""
    for arch in ARCHS:
        cache = Model(reduced_config(arch), device="cpu").init_cache(2, 16)
        state = cache["wkv"] if arch == "rwkv6-7b" else cache["ssm"]
        assert state.dtype == torch.float32
        assert all(v.dtype == torch.bfloat16 for k, v in cache.items()
                   if k not in ("wkv", "ssm"))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, use_kernels):
    _, _, tp = _models(arch)
    got = _port(arch, use_kernels=use_kernels).forward(
        tp, {"tokens": torch.from_numpy(_tokens())})
    np.testing.assert_allclose(got.detach().numpy(), _jax_forward(arch), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch):
    """Prefill 6 tokens into a 12-position cache: the last logits and
    every cache leaf (states, and the hybrid's K/V padded to max_seq)
    against the reference's; then 3 decode steps against its parallel
    forward (``tests/test_train_serve.py:140``)."""
    jm, jp, tp = _models(arch)
    toks = _tokens()
    want_logits, want = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :6])}, 12)
    logits, cache = _port(arch).prefill(tp, torch.from_numpy(toks[:, :6]).long(), 12)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **LOGIT_TOL)
    assert sorted(cache) == sorted(want)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        assert leaf.dtype == torch.float32
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[name]), **LOGIT_TOL,
                                   err_msg=name)
    ref = _jax_forward(arch)
    model = _port(arch)
    for t in range(6, 9):
        logits, cache = model.decode_step(tp, cache, torch.from_numpy(toks[:, t]).long(),
                                          torch.full((2,), t, dtype=torch.int32),
                                          attend_len=16 if t % 2 else None)
        np.testing.assert_allclose(logits.numpy(), ref[:, t], **PREFILL_DECODE_TOL,
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_state_matches_forward(arch):
    """``tests/test_arch_smoke.py:90``: 8 teacher-forced decode steps from
    an empty state reproduce the parallel forward within 2e-3; each step
    writes its states into the cache dict it was given, in place."""
    _, _, tp = _models(arch)
    toks = _tokens()
    model = _port(arch)
    cache = model.init_cache(2, 64)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for t in range(8):
        logits, out = model.decode_step(tp, cache, torch.from_numpy(toks[:, t]).long(),
                                        torch.full((2,), t, dtype=torch.int32))
        assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
        np.testing.assert_allclose(logits.numpy(), _jax_forward(arch)[:, t], **DECODE_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _reqs():
    rng = np.random.default_rng(11)
    return [(i, rng.integers(0, 512, int(rng.integers(5, 14))).tolist(),
             int(rng.integers(4, 8))) for i in range(3)]


# a kernel fault at round 2: the step restart requeues every live request
# (its generated tokens folded into its prompt) and prefills it again
REQUEUE = ((("kind", "kernel"), ("step", 2)),)


def _jax_serve(arch, faults=None):
    """The reference engine's greedy dense tokens and its recoveries, once
    per schedule, from one engine an arch (its compiled steps shared)."""
    key = ("serve", arch, faults)
    if key not in _CACHE:
        if faults is not None:
            _jax_serve(arch)
        if ("engine", arch) not in _CACHE:
            jm, jp, _ = _models(arch)
            _CACHE[("engine", arch)] = JaxServeEngine(jm, jp, **ENGINE)
        eng = _CACHE[("engine", arch)]
        kw = {}
        if faults is not None:
            kw["faults"] = JaxFaultSchedule([JaxFault(**dict(f)) for f in faults])
        before = eng.recoveries
        _CACHE[key] = (eng.serve([JaxRequest(u, list(p), n) for u, p, n in _reqs()],
                                 **kw), eng.recoveries - before)
    return _CACHE[key]


@pytest.mark.parametrize("case", ["fused", "seed_loop", "requeue"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_dense_tokens_match_reference(arch, case):
    _, _, tp = _models(arch)
    eng = ServeEngine(_port(arch), tp, fused=case != "seed_loop", **ENGINE)
    kw = {}
    if case == "requeue":
        kw["faults"] = FaultSchedule([Fault(**dict(f)) for f in REQUEUE])
    got = eng.serve([Request(u, list(p), n) for u, p, n in _reqs()], **kw)
    want, _ = _jax_serve(arch)
    assert got == want
    # one request a prefill, at its exact length
    assert all(len(uids) == 1 and bucket == lens[0]
               for uids, bucket, lens in eng.last_prefill_groups)
    if case == "requeue":
        want_faulted, recoveries = _jax_serve(arch, REQUEUE)
        assert got == want_faulted
        assert eng.recoveries == recoveries == 1
        assert any(eng.last_stats[u]["retries"] for u, _, _ in _reqs())


class _CaptureLikeGraphs(StepGraphs):
    """A CPU stand-in for ``StepGraphs`` that runs each step as a capture
    does on the card: a key's first run executes the step once (the
    warm-up), puts its ``restore`` tensors back, then executes it again
    (the first replay).  A state the step advances in place and the
    engine does not list in ``restore`` would advance twice."""

    def __init__(self):
        super().__init__("cpu", enabled=False)
        self.seen = set()

    def run(self, key, fn, restore=()):
        if key not in self.seen:
            self.seen.add(key)
            saved = [t.clone() for t in restore]
            fn()
            for t, s in zip(restore, saved):
                t.copy_(s)
        return fn()


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_step_warm_up_restores_the_states(arch):
    """The engine hands a capture's warm-up the recurrent state leaves
    beside tok / pos / remaining (``Model.state_leaves``), so the served
    tokens stay the reference's when every step key is captured first."""
    _, _, tp = _models(arch)
    eng = ServeEngine(_port(arch), tp, **ENGINE)
    eng._graphs = _CaptureLikeGraphs()
    got = eng.serve([Request(u, list(p), n) for u, p, n in _reqs()])
    assert got == _jax_serve(arch)[0]
    assert eng._graphs.seen
    names = ("shift_tm", "wkv", "shift_cm") if arch == "rwkv6-7b" else ("conv", "ssm")
    assert [id(t) for t in eng._advanced_states()] == [id(eng._dev["cache"][n])
                                                      for n in names]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_serve(arch):
    """``generate`` copies the prefill's cache into its own buffers leaf
    by leaf (state leaves whole) and gives the served greedy tokens."""
    _, _, tp = _models(arch)
    eng = ServeEngine(_port(arch), tp, **ENGINE)
    u, prompt, n = _reqs()[0]
    assert eng.generate([prompt], n)[0].tolist() == _jax_serve(arch)[0][u]


def _refusal(build):
    with pytest.raises(ValueError) as err:
        build()
    return str(err.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_refused_by_model_and_engine_as_reference(arch):
    """``tests/test_kv_cache.py:312`` and ``tests/test_paged_serving.py:169``."""
    jm, jp, tp = _models(arch)
    assert not _port(arch).supports_paged() and not jm.supports_paged()
    assert (_refusal(lambda: _port(arch).init_cache(2, 32, layout="paged"))
            == _refusal(lambda: jm.init_cache(2, 32, layout="paged")))
    for kw in (dict(cache_layout="paged"), dict(cache_layout="paged", spec_k=2)):
        assert (_refusal(lambda: ServeEngine(_port(arch), tp, **ENGINE, **kw))
                == _refusal(lambda: JaxServeEngine(jm, jp, **ENGINE, **kw)))


def test_hybrid_self_draft_refused_as_reference():
    jm, jp, tp = _models("zamba2-2.7b")
    want = _refusal(lambda: jax_spec_decode.make_self_draft(jm, jp, 6))
    assert _refusal(lambda: make_self_draft(_port("zamba2-2.7b"), tp, 6)) == want
    assert "hybrid" in want
    # RWKV6 truncates as a dense model does: the first layers' views
    dm, dp = make_self_draft(_port("rwkv6-7b"), _models("rwkv6-7b")[2], 2)
    assert dm.cfg.n_layers == 2 and dp["layers"]["tm"]["wr"].shape[0] == 2


def _target():
    """qwen2 reduced: the reference model and params, the port's model and
    params carried over."""
    key = ("target",)
    if key not in _CACHE:
        jm = JaxModel(jax_reduced_config(TARGET), compute_dtype=jnp.float32, remat=False)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
        tm = Model(reduced_config(TARGET), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(TARGET),
                               device="cpu")
        _CACHE[key] = (jm, jp, tm, tp)
    return _CACHE[key]


def _drafts(arch):
    """The reference's registry draft for the qwen2 target, and the port's
    registry draft model with the reference draft's weights.  The
    reference draft is built as its ``resolve_draft(target, arch,
    seed=0)`` builds it (the reduced config in the target's vocabulary,
    the target's compute dtype and backends, ``init(PRNGKey(0))``) and
    handed over as a (model, params) pair, its weights ``_models``'s:
    the same config and key, initialized once, jitted."""
    key = ("draft", arch)
    if key not in _CACHE:
        jm, jp, tm, tp = _target()
        jcfg = jax_reduced_config(arch)
        assert jcfg.vocab == jm.cfg.vocab          # resolve_draft keeps it as it is
        jdm = JaxModel(jcfg, compute_dtype=jm.compute_dtype, decode_backend=jm.decode_backend,
                       attn_backend=jm.attn_backend)
        jdm, jdp = jax_spec_decode.resolve_draft(jm, jp, (jdm, _models(arch)[1]))
        tdm, _ = resolve_draft(tm, tp, arch, seed=0)
        tdp = params_from_numpy(jax.tree.map(np.asarray, jdp), tdm.cfg, device="cpu")
        _CACHE[key] = (jdm, jdp, tdm, tdp)
    return _CACHE[key]


def _spec_reqs():
    rng = np.random.default_rng(7)
    return [(i, rng.integers(0, 512, int(rng.integers(5, 14))).tolist(), 6)
            for i in range(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_draft_builds_the_reduced_recurrent_draft(arch):
    dm, dp = resolve_draft(*_target()[2:], arch, seed=0)
    want = reduced_config(arch)
    assert dm.cfg.family == want.family and dm.cfg.n_layers == want.n_layers
    assert dm.cfg.vocab == 512 and dp["embed"].shape[0] == 512
    assert leaf_paths(dp) == list(expected_leaves(dm.cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_engine_with_recurrent_draft_matches_reference(arch):
    """qwen2 on 8-token pages, spec_k 4, the recurrent draft proposing:
    the reference spec engine's tokens and each request's accept counts
    on the same draft weights."""
    jm, jp, tm, tp = _target()
    jdm, jdp, tdm, tdp = _drafts(arch)
    reqs = _spec_reqs()
    want_eng = JaxServeEngine(jm, jp, draft=(jdm, jdp), **SPEC)
    want = want_eng.serve([JaxRequest(u, list(p), n) for u, p, n in reqs])
    eng = ServeEngine(tm, tp, draft=(tdm, tdp), **SPEC)
    eng._graphs = _CaptureLikeGraphs()     # the draft's states restored too
    got = eng.serve([Request(u, list(p), n) for u, p, n in reqs])
    assert got == want
    for u, _, _ in reqs:
        for k in ("spec_steps", "spec_tokens"):
            assert eng.last_stats[u][k] == want_eng.last_stats[u][k], (u, k)
    assert all(eng.last_stats[u]["spec_steps"] > 0 for u, _, _ in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_draft_state_follows_reference(arch):
    """Pinned as the reference behaves (its spec step carries the advanced
    draft cache out): a recurrent draft prefills the prompt right-padded
    to the target's prompt bucket, stepping through the padding, and each
    spec step advances its state by the whole window's T - 1 proposals,
    whatever the target accepts.  One request of max_new 2: one prefill,
    one spec step committing one token, its key captured first."""
    _, _, tm, tp = _target()
    _, _, tdm, tdp = _drafts(arch)
    prompt = _spec_reqs()[0][1]
    eng = ServeEngine(tm, tp, draft=(tdm, tdp), pipeline=False, **SPEC)
    eng._graphs = _CaptureLikeGraphs()     # a capture's warm-up restores them
    got = eng.serve([Request(0, list(prompt), 2)])[0]
    state = "wkv" if arch == "rwkv6-7b" else "ssm"

    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :len(prompt)] = torch.as_tensor(prompt)
    last = torch.as_tensor([len(prompt) - 1])
    _, cache = tdm.prefill(tdp, padded, 48, last)
    _, exact = tdm.prefill(tdp, padded[:, :len(prompt)], 48)
    assert not torch.allclose(cache[state], exact[state])
    # the window: the target's first token, then the draft's 3 proposals
    # (the engine steps a 2-slot batch, this a 1-row one: the sums may
    # round apart, far less than one step moves the state)
    tok = torch.as_tensor([got[0]])
    states = []
    for i in range(3):
        logits, cache = tdm.decode_step(tdp, cache, tok,
                                        torch.as_tensor([len(prompt) + i], dtype=torch.int32))
        tok = torch.argmax(logits, dim=-1)
        states.append(cache[state].clone())
    slot = eng._dev["draft_cache"][state][:, :1]
    torch.testing.assert_close(slot, states[2], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(slot, states[1], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_dense_and_paged_refusal(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                          "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    assert len(out["results"]) == 2
    assert all(len(v) == 3 for v in out["results"].values())
    assert arch in capsys.readouterr().out
    with pytest.raises(ValueError, match="paged cache layout"):
        serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                        "--prompt-len", "8", "--max-new", "3", "--max-seq", "32",
                        "--cache-layout", "paged"])


# ---------------------------------------------------------------------------
# the attention sites at Zamba2's full head dim, 80
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_len,causal", [(None, True), (None, False), ([40, 13], False)])
def test_plain_flash_at_head_dim_80_matches_reference_ref(kv_len, causal):
    """The plain flash forward (and the wrapper's CPU route) at D = Dv = 80
    against the reference's ``flash_attention/ref.py::attention_ref``, per
    (batch row, head); a valid length as that oracle over the row's first
    kv_len keys."""
    rng = np.random.default_rng(21)
    b, s, h = 2, 40, 2
    q, k, v = (rng.standard_normal((b, s, h, 80)).astype(np.float32) for _ in "qkv")
    lens = None if kv_len is None else torch.as_tensor(kv_len, dtype=torch.int32)
    got, _ = flash_attention_ref(*map(_tensor, (q, k, v)), lens, causal=causal)
    got_w, _ = flash_attention_fwd(*map(_tensor, (q, k, v)), lens, causal=causal)
    assert torch.equal(got, got_w)
    oracle = jax.jit(functools.partial(jax_flash_ref.attention_ref, causal=causal))
    for i in range(b):
        n = s if kv_len is None else kv_len[i]
        want = oracle(*(jnp.asarray(a[i, :m].transpose(1, 0, 2))
                        for a, m in ((q, s), (k, n), (v, n))))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want).transpose(1, 0, 2),
                                   **ATTN_TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_plain_flash_decode_at_head_dim_80_matches_reference_ref(g):
    """The plain dense decode (and the wrapper's CPU route) at D = 80,
    Zamba2's G = 1 and a grouped G = 4, against the reference's
    ``decode_attention/ref.py``."""
    rng = np.random.default_rng(22)
    b, s, hkv = 3, 50, 2
    q = rng.standard_normal((b, hkv, g, 80)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, 80)).astype(np.float32) for _ in "kv")
    pos = np.asarray([0, 31, 49], np.int32)
    got = flash_decode_ref(*map(_tensor, (q, k, v)), torch.from_numpy(pos))
    assert torch.equal(got, flash_decode(*map(_tensor, (q, k, v)), torch.from_numpy(pos)))
    want = jax.jit(jax_decode_ref.decode_attention_ref)(*map(jnp.asarray, (q, k, v, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
