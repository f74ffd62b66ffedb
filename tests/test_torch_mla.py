"""MLA serving (MiniCPM3-4B, ROADMAP A14b) in the port against the
reference on the CPU.

Reduced MiniCPM3 (4 layers, d_model 256, 4 heads, q rank 64, kv rank 32,
q/k heads of 32 nope + 16 rope dims, v heads of 32), fp32, the reference's
weights carried over by ``params_from_numpy``.  The cases:
- MLA-shaped attention (D 48, Dv 32): the port's plain ``gqa_attention``,
  ``flash_attention_ref`` and the wrapper's CPU path against the
  reference's ``gqa_attention`` through the Pallas kernel (interpret mode)
  and its jnp path, and ``pv_bf16`` on the plain path (the counterpart of
  ``tests/test_train_prefill_fastpath.py:69``);
- ``forward`` logits, on the kernel wrappers and on the plain path, and a
  ``wf`` SW model, whose two latent norms stay on the default reduction
  form as the reference's do;
- prefill then decode against the reference's forward, and the
  ``latent``/``rope`` cache leaves against the reference's prefill
  (``tests/test_train_serve.py:141``, ``tests/test_arch_smoke.py:111``);
- ``ServeEngine`` greedy tokens on the dense layout, fused, seed loop and
  through a forced requeue, against the reference engine's;
- the paged layout and ``spec_k > 1`` refused as the reference refuses
  them, in the engine and in the serving CLI."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.layers import WarpFeatureConfig as JaxWF  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.faults import Fault as JaxFault  # noqa: E402
from repro.serve.faults import FaultSchedule as JaxFaultSchedule  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.attention import gqa_attention  # noqa: E402
from repro_torch.models.layers import WarpFeatureConfig  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import Fault, FaultSchedule  # noqa: E402
from repro_torch.testing import expected_leaves, leaf_paths, params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small torch ops; one intra-op thread keeps them fast on a
    loaded CPU (as ``test_torch_spec_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "minicpm3-4b"
# the reference's tolerances: attention at D 48 (its Pallas-vs-jnp check),
# logits through 4 fp32 layers (XLA and PyTorch order their sums
# differently), prefill/decode against the parallel forward
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=5e-3, atol=5e-3)
ENGINE = dict(max_seq=48, batch_slots=2)
_CACHE = {}


def _models():
    """(reference model, its params, port params) of reduced MiniCPM3."""
    if "models" not in _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32, remat=False)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH),
                               device="cpu")
        _CACHE["models"] = (jm, jp, tp)
    return _CACHE["models"]


def _port(**kw):
    return Model(reduced_config(ARCH), device="cpu", dtype=torch.float32, **kw)


def _tokens(b=2, s=10, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _jax_forward(tokens, wf=None):
    key = ("forward", wf)
    if key not in _CACHE:
        jm, jp, _ = _models()
        if wf is not None:
            jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32,
                          remat=False, wf=JaxWF(wf))
        _CACHE[key] = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    return _CACHE[key]


# ---------------------------------------------------------------------------
# MLA-shaped attention: Dv != D
# ---------------------------------------------------------------------------

def _mla_qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((1, 64, 4, 48)).astype(np.float32),
            rng.standard_normal((1, 64, 4, 48)).astype(np.float32),
            rng.standard_normal((1, 64, 4, 32)).astype(np.float32))


def _jax_attention(backend, pv_bf16=False):
    key = ("attn", backend, pv_bf16)
    if key not in _CACHE:
        q, k, v = (jnp.asarray(a) for a in _mla_qkv())
        _CACHE[key] = np.asarray(jax_attention.gqa_attention(
            q, k, v, causal=True, pv_bf16=pv_bf16, backend=backend))
    return _CACHE[key]


PORT_ATTENTION = {
    "plain": lambda q, k, v: gqa_attention(q, k, v, use_kernel=False),
    "flash_ref": lambda q, k, v: flash_attention_ref(q, k, v)[0],
    "wrapper": lambda q, k, v: gqa_attention(q, k, v, use_kernel=True),
}


@pytest.mark.parametrize("backend", ["kernel", "jnp"])
@pytest.mark.parametrize("path", list(PORT_ATTENTION))
def test_mla_shaped_attention_matches_reference(path, backend):
    """(1, 64, 4, 48) q/k over (.., 32) v: the output has the value head
    dim, on every port path, against the Pallas kernel (interpret mode)
    and the reference's jnp path."""
    q, k, v = (torch.from_numpy(a) for a in _mla_qkv())
    got = PORT_ATTENTION[path](q, k, v)
    assert got.shape == (1, 64, 4, 32)
    np.testing.assert_allclose(got.numpy(), _jax_attention(backend), **ATTN_TOL)


def test_mla_shaped_attention_pv_bf16_plain_path():
    """pv_bf16 on the plain path: P and V contracted in bf16, as the
    reference's jnp path, within bf16's rounding of the fp32 function."""
    q, k, v = (torch.from_numpy(a) for a in _mla_qkv())
    got = gqa_attention(q, k, v, pv_bf16=True, use_kernel=False).numpy()
    np.testing.assert_allclose(got, _jax_attention("jnp", pv_bf16=True), **ATTN_TOL)
    assert np.abs(got - _jax_attention("jnp")).max() > 1e-5   # it did round


def test_flash_grads_at_mla_shape_match_reference():
    """``flash_mha``'s gradients on CPU tensors (``FlashAttention``: the
    plain forward and backward, dO and dv of the value head dim) against
    ``jax.vjp`` of the reference's ``gqa_attention`` (jnp path), at the
    reference's ``test_flash_grad_parity_mla_value_dim`` shape and
    tolerance."""
    from repro_torch.kernels.flash_attention.ops import flash_mha

    q, k, v = _mla_qkv()
    g = np.random.default_rng(4).standard_normal((1, 64, 4, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jax_attention.gqa_attention(
        a, b_, c, causal=True, backend="jnp"), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    flash_mha(*ts).backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3, atol=5e-4)


def test_flash_wrapper_counts_no_cpu_launch_and_lse():
    """On CPU tensors the wrapper is its plain version: the same o and lse,
    no launch counted."""
    q, k, v = (torch.from_numpy(a) for a in _mla_qkv())
    before = (flash_attention_fwd.launches_dv, flash_attention_fwd.launches_dv_f32)
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention_ref(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert lse.shape == (1, 4, 64)
    assert (flash_attention_fwd.launches_dv, flash_attention_fwd.launches_dv_f32) == before


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_config_and_leaves_follow_reference():
    """The full and reduced configs carry the reference's MLA fields, and
    the port's own init makes the reference's leaves and shapes."""
    from repro.configs.registry import get_config as jax_get_config

    for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
        c, jc = get(ARCH), jget(ARCH)
        for f in ("attn_type", "n_heads", "n_kv_heads", "q_lora_rank", "kv_lora_rank",
                  "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "d_model",
                  "n_layers", "d_ff", "vocab"):
            assert getattr(c, f) == getattr(jc, f), f
    _, jp, _ = _models()
    mine = _port().init(torch.Generator().manual_seed(0))
    assert leaf_paths(mine) == leaf_paths(jp) == list(expected_leaves(reduced_config(ARCH)))

    def leaf(tree, path):
        for part in path.split("."):
            tree = tree[part]
        return tree

    for path in leaf_paths(mine):
        assert tuple(leaf(mine, path).shape) == tuple(leaf(jp, path).shape), path


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits_match_reference(use_kernels):
    _, _, tp = _models()
    toks = _tokens()
    got = _port(use_kernels=use_kernels).forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.detach().numpy(), _jax_forward(toks), **LOGIT_TOL)


def test_sw_model_keeps_latent_norms_on_default_form():
    """A wf='sw' model reduces ln1 / ln2 / ln_f by the PR-transformed lane
    loops; the latent norms stay on the default form in both packages.
    Both packages' logits agree."""
    _, _, tp = _models()
    toks = _tokens(b=1, s=6)
    got = _port(wf=WarpFeatureConfig("sw")).forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.detach().numpy(), _jax_forward(toks, wf="sw"),
                               **LOGIT_TOL)


def _jax_prefill(tokens, max_seq):
    key = ("prefill", max_seq)
    if key not in _CACHE:
        jm, jp, _ = _models()
        logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, max_seq)
        _CACHE[key] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    return _CACHE[key]


def test_prefill_cache_and_decode_match_reference():
    """Prefill 6 tokens (the latent cache padded to max_seq), then decode
    the next 3 one at a time: logits against the reference's parallel
    forward, the cache leaves against the reference's prefill."""
    _, _, tp = _models()
    b, s_prompt, s_total, max_seq = 2, 6, 9, 16
    toks = _tokens(b=b, s=s_total, seed=5)
    ref = np.asarray(_models()[0].forward(_models()[1], {"tokens": jnp.asarray(toks)}))
    model = _port()
    logits, cache = model.prefill(tp, torch.from_numpy(toks[:, :s_prompt]), max_seq)
    want_logits, want_cache = _jax_prefill(toks[:, :s_prompt], max_seq)
    cfg = reduced_config(ARCH)
    assert sorted(cache) == ["latent", "rope"]
    assert cache["latent"].shape == (cfg.n_layers, b, max_seq, cfg.kv_lora_rank)
    assert cache["rope"].shape == (cfg.n_layers, b, max_seq, cfg.qk_rope_head_dim)
    for name in ("latent", "rope"):
        np.testing.assert_allclose(cache[name].numpy(), want_cache[name], **DECODE_TOL)
        assert not cache[name][:, :, s_prompt:].any()
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), ref[:, s_prompt - 1], **DECODE_TOL)
    for t in range(s_prompt, s_total):
        pos = torch.full((b,), t, dtype=torch.int32)
        logits, cache = model.decode_step(tp, cache, torch.from_numpy(toks[:, t]), pos,
                                          attend_len=16 if t % 2 else None)
        np.testing.assert_allclose(logits.numpy(), ref[:, t], **DECODE_TOL,
                                   err_msg=f"decode step {t}")


def test_decode_from_empty_cache_matches_forward():
    """The reference's ``test_attention_decode_matches_forward`` for MLA:
    decode 8 tokens from an empty dense cache."""
    _, _, tp = _models()
    toks = _tokens(b=2, s=8, seed=9)
    ref = np.asarray(_models()[0].forward(_models()[1], {"tokens": jnp.asarray(toks)}))
    model = _port()
    cache = model.init_cache(2, 64)
    for t in range(8):
        logits, cache = model.decode_step(tp, cache, torch.from_numpy(toks[:, t]),
                                          torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), ref[:, t], **DECODE_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _reqs():
    rng = np.random.default_rng(11)
    return [(i, rng.integers(0, 512, int(rng.integers(5, 14))).tolist(),
             int(rng.integers(4, 9))) for i in range(5)]


def _jax_serve(faults=None):
    """The reference engine's greedy dense tokens, once per schedule."""
    key = ("serve", faults)
    if key not in _CACHE:
        jm, jp, _ = _models()
        eng = JaxServeEngine(jm, jp, **ENGINE)
        kw = {}
        if faults is not None:
            kw["faults"] = JaxFaultSchedule([JaxFault(**dict(f)) for f in faults])
        _CACHE[key] = (eng.serve([JaxRequest(u, list(p), n) for u, p, n in _reqs()],
                                 **kw), eng.recoveries)
    return _CACHE[key]


# a kernel fault at round 2: the step restart requeues every live request
# (its generated tokens folded into its prompt) and prefills it again
REQUEUE = ((("kind", "kernel"), ("step", 2)),)


@pytest.mark.parametrize("case", ["fused", "seed_loop", "requeue"])
def test_engine_dense_tokens_match_reference(case):
    _, _, tp = _models()
    eng = ServeEngine(_port(), tp, fused=case != "seed_loop", **ENGINE)
    kw = {}
    if case == "requeue":
        kw["faults"] = FaultSchedule([Fault(**dict(f)) for f in REQUEUE])
    got = eng.serve([Request(u, list(p), n) for u, p, n in _reqs()], **kw)
    want, _ = _jax_serve()
    assert got == want
    if case == "requeue":
        want_faulted, recoveries = _jax_serve(REQUEUE)
        assert got == want_faulted
        assert eng.recoveries == recoveries == 1
        assert any(eng.last_stats[u]["retries"] for u, _, _ in _reqs())


def test_engine_generate_matches_serve():
    """``generate`` (its own dense buffers, copied from the prefill's
    latent cache by leaf name) gives the served greedy tokens."""
    _, _, tp = _models()
    eng = ServeEngine(_port(), tp, **ENGINE)
    u, prompt, n = _reqs()[0]
    got = eng.generate([prompt], n)[0].tolist()
    assert got == _jax_serve()[0][u]


def _refusal(build):
    with pytest.raises(ValueError) as err:
        build()
    return str(err.value)


@pytest.mark.parametrize("kw", [dict(cache_layout="paged"), dict(spec_k=2),
                                dict(cache_layout="paged", spec_k=2, draft="self:1")])
def test_paged_and_spec_refused_as_reference(kw):
    jm, jp, tp = _models()
    want = _refusal(lambda: JaxServeEngine(jm, jp, **ENGINE, **kw))
    got = _refusal(lambda: ServeEngine(_port(), tp, **ENGINE, **kw))
    assert got == want


def test_paged_cache_refused_by_model():
    jm, _, _ = _models()
    want = _refusal(lambda: jm.init_cache(2, 32, layout="paged"))
    assert _refusal(lambda: _port().init_cache(2, 32, layout="paged")) == want
    assert not _port().supports_paged() and not jm.supports_paged()


def test_mla_needs_the_dense_family():
    cfg = dataclasses.replace(reduced_config(ARCH), family="moe", n_experts=8, top_k=2)
    with pytest.raises(ValueError):
        Model(cfg, device="cpu")
    with pytest.raises(ValueError):
        Model(dataclasses.replace(reduced_config(ARCH), attn_type="none"), device="cpu")


def test_serve_cli_dense_and_paged_refusal(capsys):
    out = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                          "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    assert all(len(v) == 3 for v in out["results"].values())
    assert "minicpm3-4b" in capsys.readouterr().out
    with pytest.raises(ValueError, match="non-MLA"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                        "--prompt-len", "8", "--max-new", "3", "--max-seq", "32",
                        "--cache-layout", "paged"])
