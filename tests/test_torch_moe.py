"""The port's MoE family against the reference on the same weights: the
plain ``moe_gating`` against the reference's Pallas kernel (interpret
mode) and ``gating_topk``, ties, bf16 and non-finite rows included;
``moe_block`` at capacity factors that do and do not drop tokens, with
GShard grouping and with a NaN decode row; ``prefill``, ``decode_step``
on both layouts, ``decode_verify_step`` and ``forward`` logits; and the
``ServeEngine``'s greedy tokens against the reference engine on the dense
and the paged layout, through preemption too.  Reduced OLMoE-1B-7B (4
layers, d 256, 4/4 heads, 8 experts, top-4) and Granite-MoE (4/2 heads)
in fp32 on the CPU."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.moe_gating.ops import moe_gating_op  # noqa: E402
from repro.kernels.moe_gating.ref import moe_gating_ref as jax_gating_oracle  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.kv_cache import PagedCacheManager as JaxManager  # noqa: E402
from repro.serve.kv_cache import scatter_prefill as jax_scatter_prefill  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.moe_gating.ops import moe_gating  # noqa: E402
from repro_torch.kernels.moe_gating.ref import moe_gating_ref  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.models.moe import gating_topk, moe_block  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import PagedCacheManager, scatter_prefill  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    expected_leaves,
    leaf_paths,
    params_from_numpy,
)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port's reduced models run many small torch ops; on a loaded CPU
    (the suite's parallel workers) intra-op threads wait at every op's
    barrier, so the module runs on one thread and restores the count
    after (as ``test_torch_sampling.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("olmoe-1b-7b", "granite-moe-1b-a400m")
# fp32 on both sides; XLA and PyTorch order their sums differently, which
# moves logits of magnitude ~1 by a few 1e-6 (test_torch_model.py)
TOL = dict(atol=1e-4, rtol=1e-4)
# one MoE layer: a few fp32 einsums over d 256, ~1e-7 apart
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
# gating weights are softmax values <= 1 from the same f32 exps, summed in
# another order: a few f32 ulps
GATE_TOL = dict(atol=1e-6, rtol=0)
_CACHE = {}


def _models(arch):
    if arch not in _CACHE:
        jm = JaxModel(jax_reduced_config(arch), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        np_params = jax.tree.map(np.asarray, jp)
        tm = Model(reduced_config(arch), device="cpu", dtype=torch.float32)
        _CACHE[arch] = dict(jm=jm, jp=jp, tm=tm, np=np_params,
                            tp=params_from_numpy(np_params, reduced_config(arch), device="cpu"))
    return _CACHE[arch]


# ---------------------------------------------------------------------------
# configs and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "d_head", "qkv_bias", "rope_theta", "norm_eps", "n_experts",
              "top_k", "capacity_factor", "infer_capacity_factor", "moe_group_size")
    for got, want in ((reduced_config(arch), jax_reduced_config(arch)),
                      (get_config(arch), jax_get_config(arch))):
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f


def test_bridge_takes_moe_trees_and_rejects_broken_ones():
    m = _models("olmoe-1b-7b")
    paths = leaf_paths(m["np"])
    assert paths == list(expected_leaves(reduced_config("olmoe-1b-7b")))
    assert "layers.moe.router" in paths and not any(".mlp." in p for p in paths)
    assert not any(p.startswith("layers.attn.b") for p in paths)   # no qkv bias
    assert leaf_paths(m["tm"].init(torch.Generator().manual_seed(0))) == paths
    for path in paths:
        ref, got = m["np"], m["tp"]
        for key in path.split("."):
            ref, got = ref[key], got[key]
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
    missing = copy.deepcopy(m["np"])
    del missing["layers"]["moe"]["w_up"]
    extra = copy.deepcopy(m["np"])
    extra["layers"]["mlp"] = {"w_gate": np.zeros(2)}
    half_bias = copy.deepcopy(m["np"])
    half_bias["layers"]["attn"]["bq"] = np.zeros(2)
    for tree in (missing, extra, half_bias):
        with pytest.raises(ValueError, match="moe-family"):
            params_from_numpy(tree, reduced_config("olmoe-1b-7b"), device="cpu")


# ---------------------------------------------------------------------------
# gating: the plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

def _gating_case(name):
    """(logits f32, is_bf16, top_k) for the named case."""
    rng = np.random.default_rng(7)
    if name.startswith("rand"):            # tests/test_kernels.py's shapes
        t, e, k = (int(v) for v in name.split("-")[1:])
        return (rng.standard_normal((t, e)) * 2).astype(np.float32), False, k
    if name == "ties":
        x = np.zeros((6, 16), np.float32)            # all ties: ids 0..3 win
        x[1] = np.repeat(np.arange(4, dtype=np.float32), 4)       # tied blocks
        x[2, ::2] = 1.0                               # every even id ties
        x[3] = -np.inf                                # the sentinel re-hits
        x[4, :2] = (-np.inf, 5.0)
        x[4, 2:] = -np.inf                            # one value above -1e30
        x[5] = -3e38                                  # below the sentinel
        return x, False, 4
    if name == "bf16":
        # small integers scaled: exact in bf16 and tied many times per row
        x = rng.integers(-4, 5, (256, 64)).astype(np.float32) * 0.25
        return x, True, 8
    if name == "nan":
        x = (rng.standard_normal((8, 64)) * 2).astype(np.float32)
        x[3, 17] = np.nan
        x[5] = np.nan
        return x, False, 8
    raise KeyError(name)


GATING_CASES = ["rand-64-32-8", "rand-256-64-8", "rand-128-128-2", "rand-512-64-1",
                "ties", "bf16", "nan"]


@pytest.mark.parametrize("case", GATING_CASES)
def test_plain_gating_matches_pallas_kernel(case):
    x, bf16, k = _gating_case(case)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.as_tensor(x).to(torch.bfloat16 if bf16 else torch.float32)
    w_want, m_want = (np.asarray(a) for a in moe_gating_op(jx, k, interpret=True))
    w_got, m_got = moe_gating(tx, k)
    assert w_got.dtype == torch.float32 and m_got.dtype == torch.int32
    np.testing.assert_array_equal(m_got.numpy(), m_want)
    np.testing.assert_allclose(w_got.numpy(), w_want, **GATE_TOL)
    # the reference model's jnp gating computes the same function
    w_jnp, m_jnp = (np.asarray(a) for a in jax_moe.gating_topk(jx, k))
    np.testing.assert_array_equal(m_got.numpy(), m_jnp.astype(np.int32))
    np.testing.assert_allclose(w_got.numpy(), w_jnp, **GATE_TOL)
    # and the model's entry point is the wrapper over any leading shape
    w3, m3 = gating_topk(tx.reshape(1, *tx.shape), k)
    assert torch.equal(m3[0], m_got.bool()) and torch.equal(w3[0].isnan(), w_got.isnan())
    if case == "ties":
        np.testing.assert_array_equal(m_got[0].numpy(), [1] * 4 + [0] * 12)
        np.testing.assert_array_equal(m_got[2].numpy()[:8], [1, 0] * 4)
        assert m_got[3].tolist() == [1] + [0] * 15     # -inf: lane 0, then sentinels
        assert m_got[4].sum() == 1 and m_got[4, 1] == 1
    if case == "ties":   # nothing above the sentinel in rows 3 and 5: 0 / 0
        assert np.isnan(w_want[[3, 5]]).all() and np.isfinite(w_want[[0, 1, 2, 4]]).all()
    rows = ~np.isnan(w_want).any(-1)
    np.testing.assert_allclose(w_got.sum(-1).numpy()[rows], 1.0, rtol=1e-5)


def test_nan_row_follows_the_kernel_not_its_oracle():
    """A row holding a NaN selects nothing and gets NaN weights, as the
    Pallas kernel (``jnp.max`` keeps the NaN, which equals no lane); the
    reference's ``lax.top_k`` oracle instead selects the NaN lane."""
    x, _, k = _gating_case("nan")
    w, m = moe_gating(torch.as_tensor(x), k)
    for row in (3, 5):
        assert m[row].sum() == 0 and torch.isnan(w[row]).all()
    others = [r for r in range(x.shape[0]) if r not in (3, 5)]
    assert (m[others].sum(-1) == k).all() and torch.isfinite(w[others]).all()
    _, m_oracle = jax_gating_oracle(jnp.asarray(x), k)
    assert np.asarray(m_oracle)[3].sum() == k          # the oracle disagrees
    w_plain, m_plain = moe_gating_ref(torch.as_tensor(x), k)
    assert torch.equal(m_plain, m) and torch.equal(w_plain.isnan(), w.isnan())


def test_gating_wrapper_refuses_what_it_cannot_take():
    x = torch.randn(4, 16)
    with pytest.raises(ValueError, match="128"):
        moe_gating(torch.randn(2, 129), 2)
    with pytest.raises(ValueError, match="top_k"):
        moe_gating(x, 0)
    with pytest.raises(ValueError, match="top_k"):
        moe_gating(x, 17)
    with pytest.raises(TypeError, match="f32/bf16"):
        moe_gating(x.half(), 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        moe_gating(torch.empty(4, 16, device="meta"), 2)
    # a router that needs a gradient goes through MoEGating and gets the
    # reference's gradient (tests/test_torch_moe_train.py), never a zero
    w, m = moe_gating(x.requires_grad_(), 2)
    assert type(w.grad_fn).__name__ == "MoEGatingBackward" and not m.requires_grad
    (w * torch.arange(16.0)).sum().backward()
    assert x.grad.abs().sum() > 0 and (x.grad[m == 0] == 0).all()
    with torch.no_grad():
        w, _ = moe_gating(x, 2)
    assert w.grad_fn is None


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_params(cfg_arch="olmoe-1b-7b"):
    p = jax_moe.init_moe_params(jax.random.PRNGKey(3), jax_reduced_config(cfg_arch))
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("cf,group", [(8.0, 0), (2.0, 0), (1.25, 0), (0.5, 0),
                                      (1.25, 4), (0.5, 4)])
def test_moe_block_matches_reference(cf, group):
    jcfg = dataclasses.replace(jax_reduced_config("olmoe-1b-7b"), moe_group_size=group)
    tcfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), moe_group_size=group)
    jp, tp = _moe_params()
    x = np.random.default_rng(8).standard_normal((2, 16, 256)).astype(np.float32)
    want = np.asarray(jax_moe.moe_block(jp, jnp.asarray(x), jcfg, capacity_factor=cf))
    got = moe_block(tp, torch.as_tensor(x), tcfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)
    # tokens past an expert's capacity are dropped: the output differs
    # from a no-drop capacity exactly when some expert overflows, and cf
    # 0.5 (half the average picks per expert) overflows
    g = group or x.shape[1]
    _, mask = gating_topk(torch.as_tensor(x).reshape(-1, g, 256) @ tp["router"], 4)
    drops = bool((mask.sum(1) > max(int(g * 4 * cf / 8), 1)).any())
    no_drop = moe_block(tp, torch.as_tensor(x), tcfg, capacity_factor=8.0)
    assert torch.allclose(got, no_drop) == (not drops)
    assert drops or cf > 0.5


def test_moe_block_nan_poisons_only_its_own_group():
    """A NaN hidden state in one decode row (each row its own group)
    poisons that row's output and no other, as in the reference."""
    cfg = reduced_config("olmoe-1b-7b")
    jp, tp = _moe_params()
    x = np.random.default_rng(9).standard_normal((3, 1, 256)).astype(np.float32)
    x[1, 0, 5] = np.nan
    want = np.asarray(jax_moe.moe_block(jp, jnp.asarray(x), jax_reduced_config(
        "olmoe-1b-7b"), capacity_factor=8.0))
    got = moe_block(tp, torch.as_tensor(x), cfg, capacity_factor=8.0).numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **BLOCK_TOL)
    assert np.isfinite(got[[0, 2]]).all()


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

def _paged_pair(m, jcache, tcache, b, s, max_seq, ps):
    """The same prefilled dense caches scattered into both packages'
    paged pools through identical managers."""
    out = []
    for model, cache, mgr_cls, scatter, asarr in (
            (m["jm"], jcache, JaxManager, jax_scatter_prefill, jnp.asarray),
            (m["tm"], tcache, PagedCacheManager, scatter_prefill, torch.as_tensor)):
        paged = model.init_cache(b, max_seq, layout="paged", page_size=ps)
        mgr = mgr_cls(paged["k_pages"].shape[1], ps, b, max_seq)
        for slot in range(b):
            mgr.admit(slot, s)
        idx = asarr(np.stack([mgr.prefill_page_idx(i, max_seq // ps) for i in range(b)]))
        pool = scatter({"k_pages": paged["k_pages"], "v_pages": paged["v_pages"]},
                       {"k": cache["k"], "v": cache["v"]}, idx)
        if mgr_cls is JaxManager:
            pool = dict(pool, block_tables=mgr.device_tables())
        else:
            paged["block_tables"] = mgr.device_tables("cpu")
            pool = paged
        out.append((pool, mgr))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_verify_logits_match_reference(arch):
    """Prefill (2 rows of 9), three greedy decode steps on the dense and on
    the paged layout, and a 3-token verify window, all within 1e-4."""
    m = _models(arch)
    jm, jp, tm, tp = m["jm"], m["jp"], m["tm"], m["tp"]
    b, s, max_seq, ps = 2, 9, 32, 8
    toks = np.random.default_rng(1).integers(0, 512, (b, s)).astype(np.int32)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq)
    got, tcache = tm.prefill(tp, torch.as_tensor(toks), max_seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)
    first = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    (jpaged, jmgr), (tpaged, tmgr) = _paged_pair(m, jcache, tcache, b, s, max_seq, ps)
    for layout in ("dense", "paged"):
        jc = jcache if layout == "dense" else jpaged
        tc = {k: v.clone() for k, v in (tcache if layout == "dense" else tpaged).items()}
        jtok, ttok, pos = jnp.asarray(first), torch.as_tensor(first), np.full((b,), s, np.int32)
        for step in range(3):
            if layout == "paged":
                for mgr in (jmgr, tmgr):
                    for slot in range(b):
                        mgr.ensure_block(slot, int(pos[0]) // ps)
                jc["block_tables"] = jmgr.device_tables()
                tc["block_tables"] = tmgr.device_tables("cpu")
            w_lg, jc = jm.decode_step(jp, jc, jtok, jnp.asarray(pos), attend_len=16,
                                      unroll=layout == "dense")
            g_lg, tc = tm.decode_step(tp, tc, ttok, torch.as_tensor(pos), attend_len=16)
            np.testing.assert_allclose(g_lg.numpy(), np.asarray(w_lg), **TOL,
                                       err_msg=f"{layout} step {step}")
            jtok = jnp.argmax(w_lg, -1).astype(jnp.int32)
            ttok = torch.argmax(g_lg, -1).to(torch.int32)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            pos = pos + 1
    # a 3-token verify window from the prefilled paged caches
    window = np.concatenate([first[:, None], toks[:, :2]], axis=1)
    pos = np.full((b,), s, np.int32)
    w_lg, _ = jm.decode_verify_step(jp, jpaged, jnp.asarray(window), jnp.asarray(pos),
                                    16, "jnp")
    g_lg, _ = tm.decode_verify_step(tp, tpaged, torch.as_tensor(window),
                                    torch.as_tensor(pos), 16)
    assert g_lg.shape == (b, 3, tm.cfg.vocab)
    np.testing.assert_allclose(g_lg.numpy(), np.asarray(w_lg), **TOL)


def test_forward_matches_reference_without_gradients():
    """Training's forward (capacity factor 1.25, which drops tokens at
    S 24) under no_grad: the logits of every position within 1e-4; and the
    plain path (``use_kernels=False``) computes the same function."""
    m = _models("olmoe-1b-7b")
    toks = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    want = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = m["tm"].forward(m["tp"], {"tokens": torch.as_tensor(toks)})
        plain = Model(reduced_config("olmoe-1b-7b"), device="cpu", dtype=torch.float32,
                      use_kernels=False).forward(m["tp"], {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


def test_trainer_refuses_the_moe_family():
    """The MoE family, refused before its gating had a backward, now
    trains: two Trainer steps of reduced OLMoE move every leaf, the
    router's included (the reference's losses: test_torch_moe_train.py)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.optim.optimizer import AdamWConfig, named_leaves
    from repro_torch.train.step import TrainState, init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = _models("olmoe-1b-7b")["tm"]
    state = init_train_state(model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in named_leaves(state.params)}
    data = SyntheticPipeline(DataConfig(vocab=512, seq_len=16, global_batch=2))
    tr = Trainer(model, data, AdamWConfig(warmup_steps=1, total_steps=2),
                 TrainerConfig(total_steps=2, vocab_chunks=2))
    state, hist = tr.run(start_state=TrainState(state.params, state.opt))
    assert len(hist) == 2 and all(np.isfinite(m["loss"]) for _, m in hist)
    for k, v in named_leaves(state.params):
        assert not torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the engine: greedy tokens equal to the reference engine's
# ---------------------------------------------------------------------------

def _reqs(seed=5):
    """Prompts of 3-11 tokens, as the reference's
    test_paged_moe_family_sequential_admission, budgets of 2-9 (enough
    growth to preempt in a 5-page pool), plus one request that completes
    at admission."""
    rng = np.random.default_rng(seed)
    out = [(i, rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
            int(rng.integers(2, 10))) for i in range(4)]
    return out + [(4, [1, 2, 3], 1)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [
    dict(max_seq=48, batch_slots=2),
    dict(max_seq=48, batch_slots=2, cache_layout="paged", page_size=8),
    # too few pages for the batch to grow: forced preempt-and-requeue
    dict(max_seq=48, batch_slots=3, cache_layout="paged", page_size=8, num_pages=5),
], ids=["dense", "paged", "paged-preempt"])
def test_serve_greedy_tokens_match_reference(arch, kw):
    """Every layout is held to the reference engine's dense tokens: the
    reference serves paged, preempting or not, exactly as dense (its own
    test_paged_moe_family_sequential_admission and test_paged_serving),
    and one reference engine per arch keeps this file short."""
    m, spec = _models(arch), _reqs()
    if (arch, "serve") not in _CACHE:
        eng = JaxServeEngine(m["jm"], m["jp"], temperature=0.0, seed=0,
                             max_seq=48, batch_slots=2)
        _CACHE[arch, "serve"] = eng.serve(
            [JaxRequest(u, list(p), n) for u, p, n in spec])
    eng = ServeEngine(m["tm"], m["tp"], **kw)
    got = eng.serve([Request(u, list(p), n) for u, p, n in spec])
    assert got == _CACHE[arch, "serve"]
    assert (eng.preemptions >= 1) == ("num_pages" in kw)
    for u, _, n in spec:
        assert eng.last_stats[u]["status"] == "ok" and len(got[u]) == n
    if kw.get("cache_layout") == "paged":
        assert eng.last_pool_stats.used_pages == 0


def test_engine_prefills_moe_requests_alone_at_their_exact_length(monkeypatch):
    """The dense family right-pads a batch to the prompt bucket; an MoE
    request prefills alone at its own length (capacity depends on it)."""
    m = _models("olmoe-1b-7b")
    shapes = []
    real = Model.prefill

    def spy(self, params, tokens, *a, **k):
        shapes.append(tuple(tokens.shape))
        return real(self, params, tokens, *a, **k)

    monkeypatch.setattr(Model, "prefill", spy)
    spec = _reqs()
    ServeEngine(m["tm"], m["tp"], max_seq=48, batch_slots=3).serve(
        [Request(u, list(p), n) for u, p, n in spec])
    assert sorted(shapes) == sorted((1, len(p)) for _, p, _ in spec)
