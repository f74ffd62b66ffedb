"""Speculative serving of an MoE target (ROADMAP A14a) on the CPU, and the
dense configs it brings.

The port's speculative engine on reduced OLMoE-1B-7B (a 2-layer self
draft, spec_k 4, 8-token pages) against the reference's non-speculative
engine and the reference's speculative engine on the same weights
(carried over by ``params_from_numpy``), greedy, at temperature 0.8 and
on a pool too small for two growing sequences (it preempts).  A verify
window of T tokens dispatches at the decode capacity max(int(T k 8 / E),
1) = 16 >= T, so no window drops an expert pick.  Beside them:
``resolve_draft`` refuses the families that need frontend embeddings as
the reference's does; ``qwen1.5-32b`` and ``qwen1.5-110b`` at reduced
size give the reference's prefill logits; and ``Model.init``'s stacked
leaves, filled in place, equal the old construction (L per-layer tensors
stacked) bit for bit.  fp32."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve import spec_decode as jax_spec_decode  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import dense_init, embed_init  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.models.moe import init_moe_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.spec_decode import resolve_draft  # noqa: E402
from repro_torch.testing import params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The engines run many small torch ops a step; one intra-op thread
    keeps them fast on a loaded CPU (as ``test_torch_sampling.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "olmoe-1b-7b"
DRAFT = "self:2"
SPEC_K = 4
PAGED = dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8)
# two slots of these requests cannot grow in 4 usable pages: it preempts
PREEMPT_PAGES = 5
_CACHE = {}


def _models(arch=ARCH):
    """(JAX model, JAX params, port model, port params) of a reduced
    config, the port's weights carried over from the reference's."""
    if arch not in _CACHE:
        jm = JaxModel(jax_reduced_config(arch), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(arch), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(arch),
                               device="cpu")
        _CACHE[arch] = (jm, jp, tm, tp)
    return _CACHE[arch]


def _reqs(n=5, seed=3, prompt_len=8):
    """Prompts of one length: an MoE prompt prefills alone at its exact
    length, so each distinct length is one more compile of the
    reference's prefill (the budgets vary)."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, prompt_len).tolist(), int(rng.integers(4, 10)))
            for i in range(n)]


def _jax_serve(temperature, spec: bool):
    """The reference's non-speculative dense engine, or its speculative
    engine (spec_k 4, the same draft, 8-token pages), once per setting.
    Its tokens are a function of (seed, uid, prompt), so the forced case
    holds the port's preempting run to the reference's ample-pool run."""
    key = (temperature, spec)
    if key not in _CACHE:
        jm, jp, _, _ = _models()
        kw = dict(spec_k=SPEC_K, draft=DRAFT, **PAGED) if spec else dict(max_seq=48,
                                                                          batch_slots=2)
        eng = JaxServeEngine(jm, jp, temperature=temperature, seed=0, **kw)
        _CACHE[key] = eng.serve([JaxRequest(u, list(p), n) for u, p, n in _reqs()])
    return _CACHE[key]


CASES = {"greedy": (0.0, None), "t08": (0.8, None), "preempt": (0.0, PREEMPT_PAGES)}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_moe_target_gives_reference_tokens(case):
    """The MoE target speculating through verify windows serves the
    reference's non-speculative tokens and the reference's speculative
    tokens; the pool drains, and the forced case preempts."""
    temperature, num_pages = CASES[case]
    kw = dict(PAGED, num_pages=num_pages) if num_pages else PAGED
    want = _jax_serve(temperature, spec=False)
    want_spec = _jax_serve(temperature, spec=True)
    _, _, tm, tp = _models()
    eng = ServeEngine(tm, tp, temperature=temperature, seed=0, spec_k=SPEC_K,
                      draft=DRAFT, **kw)
    got = eng.serve([Request(u, list(p), n) for u, p, n in _reqs()])
    assert got == want
    assert got == want_spec
    assert eng.draft_model.cfg.family == "moe" and eng.draft_model.cfg.n_layers == 2
    pool = eng.last_pool_stats
    assert pool.used_pages == 0 and pool.retracts > 0
    assert all(eng.last_stats[u]["spec_steps"] > 0 for u, _, _ in _reqs())
    if num_pages:
        assert eng.preemptions >= 1


@pytest.mark.parametrize("arch,family", [("whisper-small", "encdec"),
                                         ("internvl2-1b", "vlm")])
def test_draft_family_check_follows_reference(monkeypatch, arch, family):
    """A registry draft whose family needs frontend embeddings is refused
    by both packages with the same message.  The port's registry holds
    only the ported families, so the case registers the reference's
    config there (its shared fields) for the length of the test."""
    jc = jax_registry.get_config(arch)
    assert jc.family == family
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    monkeypatch.setitem(registry.ARCHS, arch, ModelConfig(
        **{k: v for k, v in dataclasses.asdict(jc).items() if k in fields}))
    jm, jp, tm, tp = _models()
    with pytest.raises(ValueError) as want:
        jax_spec_decode.resolve_draft(jm, jp, arch)
    with pytest.raises(ValueError) as got:
        resolve_draft(tm, tp, arch)
    assert str(got.value) == str(want.value)
    assert "frontend embeddings" in str(got.value)
    # the token-only families still draft: an MoE registry draft for the
    # dense target, in the target's vocabulary
    dm, dp = resolve_draft(*_models("qwen2-1.5b")[2:], "granite-moe-1b-a400m")
    assert dm.cfg.family == "moe" and dp["embed"].shape[0] == 512


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "qwen1.5-110b"])
def test_dense_configs_prefill_matches_reference(arch):
    """The two dense configs are the reference's (every shared field) and
    their reduced models give the reference's prefill logits (rows padded
    to 12 tokens, each read at its last real one) within 1e-4."""
    jc = jax_registry.get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(get_config(arch), f.name) == getattr(jc, f.name), f.name
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    last = np.array([11, 7], np.int32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16, jnp.asarray(last))
    got, _ = tm.prefill(tp, torch.as_tensor(toks), 16, torch.as_tensor(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _stacked_init(model, gen):
    """``Model.init`` as it was before its leaves were filled in place:
    L per-layer tensors, then ``torch.stack``, the same draws in the same
    order."""
    cfg, kw = model.cfg, dict(device=model.device, dtype=model.param_dtype)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def stacked(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, **kw) for _ in range(L)])

    attn = {"wq": stacked(d, hq * dh), "wk": stacked(d, hkv * dh),
            "wv": stacked(d, hkv * dh), "wo": stacked(hq * dh, d)}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros(L, hq * dh, **kw), bk=torch.zeros(L, hkv * dh, **kw),
                    bv=torch.zeros(L, hkv * dh, **kw))
    if cfg.family == "moe":
        per_layer = [init_moe_params(gen, cfg, **kw) for _ in range(L)]
        ffn = {"moe": {k: torch.stack([p[k] for p in per_layer]) for k in per_layer[0]}}
    else:
        ffn = {"mlp": {"w_gate": stacked(d, f), "w_up": stacked(d, f),
                       "w_down": stacked(f, d)}}
    return {"embed": embed_init(gen, cfg.vocab, d, **kw), "ln_f": torch.ones(d, **kw),
            "lm_head": dense_init(gen, d, cfg.vocab, **kw),
            "layers": {"ln1": torch.ones(L, d, **kw), "ln2": torch.ones(L, d, **kw),
                       "attn": attn, **ffn}}


@pytest.mark.parametrize("arch,dtype", [("qwen1.5-32b", torch.float32),
                                        ("olmoe-1b-7b", torch.bfloat16)])
def test_in_place_init_equals_stacked(arch, dtype):
    """Filling each stacked leaf in place draws exactly what building the
    layers and stacking them drew: every leaf ``torch.equal``."""
    model = Model(reduced_config(arch), device="cpu", dtype=dtype)
    got = model.init(torch.Generator().manual_seed(7))
    want = _stacked_init(model, torch.Generator().manual_seed(7))

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}{k}.")
            else:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), path + k

    walk(got, want)
