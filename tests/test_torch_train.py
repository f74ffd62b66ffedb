"""The port's training path against the reference on the CPU: the flash
backward's plain version against the Pallas backward (interpret mode), the
FlashAttention and RMSNorm Functions against ``jax.grad`` of ``flash_mha``
and ``rmsnorm_op``, the chunked loss, ``backbone``/``forward``, the loss
and every parameter gradient against ``jax.value_and_grad`` of the
reference's loss, AdamW and its schedule, the trainer, accumulation, the
data pipeline and the CLI.  Reduced qwen2-1.5b (4 layers, d_model 256,
4 query heads over 1 KV head, d_head 64, vocab 512) in fp32; inputs from
numpy with a seed, handed to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd as jax_flash_bwd,
)
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm_op as jax_rmsnorm_op  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_mha  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    DENSE_LEAVES,
    adamw_state_from_numpy,
    params_from_numpy,
    to_numpy,
)
from repro_torch.train.step import (  # noqa: E402
    TrainState,
    chunked_xent_loss,
    make_grad_fn,
    make_loss_fn,
    value_and_grad,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "qwen2-1.5b"
# a kernel's plain version against the Pallas kernel: the same fp32
# arithmetic with the sums taken in another order
BWD_TOL = dict(atol=1e-5, rtol=1e-5)
# the model in fp32 through 4 layers, forward and backward: XLA and
# PyTorch block their matmuls and reductions differently (~1e-6 on values
# of magnitude ~1); a wrong mask, rope or cast moves them by > 1e-2
TOL = dict(atol=1e-5, rtol=1e-4)
SEQ, BATCH, CHUNKS = 16, 2, 4
_CACHE = {}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _models():
    """Reference (attention through the Pallas kernels in interpret mode)
    and port on the same weights, and one numpy batch."""
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32,
                      param_dtype=jnp.float32, attn_backend="kernel")
        jp = jm.init(jax.random.PRNGKey(3))
        np_params = jax.tree.map(np.asarray, jp)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
        _CACHE.update(jm=jm, jp=jp, np=np_params, toks=toks,
                      tm=Model(reduced_config(ARCH), device="cpu", dtype=torch.float32))
    return _CACHE


def _tp():
    """A fresh copy of the bridged weights (the port's steps update them
    in place)."""
    return params_from_numpy(_models()["np"], reduced_config(ARCH), device="cpu")


def _jax_loss_and_grads():
    m = _models()
    if "jloss" not in m:
        loss_fn = jstep.make_loss_fn(m["jm"], vocab_chunks=CHUNKS)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            m["jp"], {"tokens": jnp.asarray(m["toks"])})
        m.update(jloss=float(loss), jgrads=jax.tree.map(np.asarray, grads))
    return m["jloss"], m["jgrads"]


# ---------------------------------------------------------------------------
# the flash backward and the two differentiable kernels
# ---------------------------------------------------------------------------

def _attn_case(rng, b, s, hq, hkv, d, kv_len, causal):
    q, do = _rand(rng, b, s, hq, d), _rand(rng, b, s, hq, d)
    k, v = _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    o, lse = flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                 None if lens is None else torch.as_tensor(lens),
                                 causal=causal)
    delta = (torch.as_tensor(do) * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse.numpy(), delta.numpy(), lens


def _heads_flat(x):          # (B, S, H, D) -> (B*H, S, D)
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("s,g,kv_len,causal,block", [
    (32, 1, None, True, 16),          # causal block skip over 2 x 2 blocks
    (37, 2, None, True, 128),         # ragged S (not a tile multiple)
    (24, 4, None, False, 8),
    (48, 2, [48, 17], True, 16),      # kv_len inside a block
    (29, 2, [29, 5], False, 128),
], ids=["g1-causal", "g2-ragged", "g4-noncausal", "g2-kvlen", "g2-noncausal-kvlen"])
def test_bwd_plain_matches_pallas(s, g, kv_len, causal, block):
    """flash_attention_bwd_ref against the reference's two Pallas kernels
    (interpret mode) on the same q, k, v, dO, lse, delta; the reference's
    dk/dv come per query head over repeated K/V and are summed per group."""
    rng = np.random.default_rng(s)
    b, hkv, d = 2, 2, 64
    hq = hkv * g
    q, k, v, do, lse, delta, lens = _attn_case(rng, b, s, hq, hkv, d, kv_len, causal)
    got = flash_attention_bwd_ref(*map(torch.as_tensor, (q, k, v, do, lse, delta)),
                                  None if lens is None else torch.as_tensor(lens),
                                  causal=causal)
    rep = lambda x: np.repeat(x, g, axis=2)                       # noqa: E731
    want = jax_flash_bwd(
        *(jnp.asarray(_heads_flat(x)) for x in (q, rep(k), rep(v), do)),
        jnp.asarray(lse.reshape(b * hq, s)), jnp.asarray(delta.reshape(b * hq, s)),
        None if lens is None else jnp.asarray(np.repeat(lens, hq)),
        causal=causal, block_q=block, block_k=block, interpret=True)
    dq, dk, dv = (np.asarray(w).reshape(b, hq, s, d) for w in want)
    np.testing.assert_allclose(got[0].numpy(), dq.transpose(0, 2, 1, 3), **BWD_TOL)
    for name, t, w in (("dk", got[1], dk), ("dv", got[2], dv)):
        summed = w.reshape(b, hkv, g, s, d).sum(2).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(t.numpy(), summed, **BWD_TOL, err_msg=name)


@pytest.mark.parametrize("kv_len,causal", [(None, True), ([21, 9], False),
                                           ([21, 14], True)])
def test_flash_attention_grads_match_jax(kv_len, causal):
    """FlashAttention (the port's custom_vjp, plain versions on the CPU)
    against jax.grad of flash_mha in interpret mode."""
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, 21, 4, 64), _rand(rng, 2, 21, 2, 64), _rand(rng, 2, 21, 2, 64)
    g = _rand(rng, 2, 21, 4, 64)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)

    def jloss(q_, k_, v_):
        o = jax_flash_mha(q_, k_, v_, causal=causal, interpret=True,
                          kv_valid_len=None if lens is None else jnp.asarray(lens))
        return jnp.sum(o * g), o

    (_, want_o), want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = flash_mha(*ts, None if lens is None else torch.as_tensor(lens), causal=causal)
    (o * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), **BWD_TOL)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **BWD_TOL)


def test_rmsnorm_grads_match_jax():
    """The RMSNorm Function's closed-form backward against jax.grad of the
    reference's rmsnorm_op (interpret mode)."""
    rng = np.random.default_rng(6)
    x, w, g = _rand(rng, 3, 5, 256), _rand(rng, 256), _rand(rng, 3, 5, 256)
    want = jax.grad(lambda a, b: jnp.sum(jax_rmsnorm_op(a, b, 1e-6, True) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    (rmsnorm_op(tx, tw, 1e-6) * torch.as_tensor(g)).sum().backward()
    for t, ref in zip((tx, tw), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **BWD_TOL)


# ---------------------------------------------------------------------------
# loss, model, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 4, 3])     # 3 does not divide S: 1
def test_chunked_xent_matches_reference(n_chunks):
    rng = np.random.default_rng(7)
    x, w = _rand(rng, 2, 16, 32), _rand(rng, 32, 128)
    t = rng.integers(0, 120, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    mask[:, -1] = 0.0
    f = lambda a, b: jstep.chunked_xent_loss(a, b, jnp.asarray(t), jnp.asarray(mask),  # noqa: E731
                                             n_chunks, real_vocab=120)
    want, (wx, ww) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = chunked_xent_loss(tx, tw, torch.as_tensor(t), torch.as_tensor(mask),
                            n_chunks, real_vocab=120)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ww), **TOL)


def test_backbone_and_forward_match_reference():
    m = _models()
    batch_j, batch_t = {"tokens": jnp.asarray(m["toks"])}, {"tokens": torch.as_tensor(m["toks"])}
    tp = _tp()
    for name in ("backbone", "forward"):
        want = jax.jit(getattr(m["jm"], name))(m["jp"], batch_j)
        got = getattr(m["tm"], name)(tp, batch_t)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


def test_loss_and_every_grad_match_reference():
    """The port's loss and all 15 parameter gradients against
    jax.value_and_grad of the reference's loss, attention through the
    Pallas forward and backward kernels (interpret mode) there and the
    FlashAttention Function here."""
    m = _models()
    want_loss, want = _jax_loss_and_grads()
    loss, grads = value_and_grad(make_loss_fn(m["tm"], vocab_chunks=CHUNKS))(
        _tp(), {"tokens": torch.as_tensor(m["toks"])})
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    got = to_numpy(grads)
    for path in DENSE_LEAVES:
        np.testing.assert_allclose(_leaf(got, path), _leaf(want, path), **TOL,
                                   err_msg=path)


def test_remat_and_plain_attention_give_the_same_gradients():
    """Remat changes what is kept, not what is computed; the plain
    attention route (autograd through the materialized softmax) gives the
    Function's gradients."""
    m = _models()
    batch = {"tokens": torch.as_tensor(m["toks"])}
    want_loss, want = _jax_loss_and_grads()
    cfg = reduced_config(ARCH)
    for model in (Model(cfg, device="cpu", dtype=torch.float32, remat=False),
                  Model(cfg, device="cpu", dtype=torch.float32, attn_backend="torch")):
        loss, grads = value_and_grad(make_loss_fn(model, vocab_chunks=CHUNKS))(_tp(), batch)
        np.testing.assert_allclose(loss.item(), want_loss, **TOL)
        got = to_numpy(grads)
        for path in DENSE_LEAVES:
            np.testing.assert_allclose(_leaf(got, path), _leaf(want, path), **TOL,
                                       err_msg=path)


def test_fp32_params_under_bf16_compute():
    """The training configuration: fp32 master weights, bf16 activations;
    gradients come back fp32 for every leaf, close to the fp32 run's."""
    m = _models()
    cfg = reduced_config(ARCH)
    model = Model(cfg, device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    own = model.init(torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in topt.leaves(own))
    loss, grads = value_and_grad(make_loss_fn(model, vocab_chunks=CHUNKS))(
        _tp(), {"tokens": torch.as_tensor(m["toks"])})
    want_loss, want = _jax_loss_and_grads()
    assert abs(loss.item() - want_loss) < 0.05 * abs(want_loss)
    assert all(g.dtype == torch.float32 for g in topt.leaves(grads))
    got = to_numpy(grads)
    for path in DENSE_LEAVES:         # bf16 compute: cosine, not allclose
        a, b = _leaf(got, path).ravel(), _leaf(want, path).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.99, (path, cos)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(scale):
    """The SAME numpy grads and a mid-run state (step 3, nonzero moments)
    through both updates.  Weight decay goes by the stacked leaf's rank
    on both sides: ln1/ln2 (L, d) and the (L, .) biases decay, ln_f does
    not."""
    m = _models()
    rng = np.random.default_rng(8)
    grads = jax.tree.map(lambda p: _rand(rng, *p.shape) * scale, m["np"])
    mom = jax.tree.map(lambda p: _rand(rng, *p.shape) * 0.01, m["np"])
    vel = jax.tree.map(lambda p: np.abs(_rand(rng, *p.shape)) * 1e-4, m["np"])
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    wp, ws, wm = jax.jit(jopt.adamw_update, static_argnums=0)(
        cfg, jax.tree.map(jnp.asarray, grads),
        jopt.AdamWState(step=jnp.asarray(3, jnp.int32), m=jax.tree.map(jnp.asarray, mom),
                        v=jax.tree.map(jnp.asarray, vel)), m["jp"])
    tcfg = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    gp, gs, gm = topt.adamw_update(tcfg, params_from_numpy(grads, reduced_config(ARCH), device="cpu"),
                                   adamw_state_from_numpy(3, mom, vel, reduced_config(ARCH),
                                                          device="cpu"),
                                   _tp())
    assert gs.step == int(ws.step) == 4
    np.testing.assert_allclose(gm["lr"], float(wm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]), rtol=1e-5)
    for got, want in ((gp, wp), (gs.m, ws.m), (gs.v, ws.v)):
        got, want = to_numpy(got), jax.tree.map(np.asarray, want)
        for path in DENSE_LEAVES:
            np.testing.assert_allclose(_leaf(got, path), _leaf(want, path),
                                       atol=1e-6, rtol=1e-6, err_msg=path)


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    got = [topt.lr_schedule(tc, s) for s in range(0, 60)]
    want = [float(jopt.lr_schedule(jc, jnp.asarray(s))) for s in range(0, 60)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[10] == pytest.approx(3e-4) and got[55] == pytest.approx(3e-5)


def test_named_leaves_follow_jax_tree_order():
    tree = {"layers": {"wq": np.zeros((2, 3)), "bq": np.ones(2)}, "embed": np.full(4, 2.0),
            "ln_f": np.full(1, 3.0)}
    want = [(jax.tree_util.keystr(path, simple=True, separator="."), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = list(topt.named_leaves(tree))
    assert [p for p, _ in got] == [p for p, _ in want] == [
        "embed", "layers.bq", "layers.wq", "ln_f"]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    assert [a is b for a, b in zip(topt.leaves(tree), jax.tree.leaves(tree))] == [True] * 4


@pytest.mark.parametrize("backend", ["attn_backend", "verify_backend"])
def test_attention_backends_share_one_enum(backend):
    m = Model(reduced_config("qwen2-1.5b"), device="cpu", dtype=torch.float32,
              use_kernels=False)
    assert m.uses_kernel("kernel", backend) and not m.uses_kernel("torch", backend)
    assert m.uses_kernel(None, backend) is False          # follows use_kernels
    with pytest.raises(ValueError, match=backend):
        m.uses_kernel("pallas", backend)
    with pytest.raises(ValueError, match="attn_backend"):
        Model(reduced_config("qwen2-1.5b"), device="cpu", attn_backend="pallas")


# ---------------------------------------------------------------------------
# trainer, accumulation, data, CLI
# ---------------------------------------------------------------------------

class _Batches:
    """A pipeline stub: the same numpy batches for both packages."""

    def __init__(self, batches, conv):
        self.batches, self.conv = batches, conv

    def batch_at(self, step):
        return {"tokens": self.conv(self.batches[step])}


def test_trainer_losses_match_reference():
    """Three Trainer steps from the bridged weights on the same batches:
    the losses agree, so the first step's gradients and two AdamW updates
    carried over."""
    m = _models()
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(3)]
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    jtr = JaxTrainer(m["jm"], _Batches(batches, jnp.asarray), jcfg,
                     JaxTrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    _, jh = jtr.run(None, start_state=jstep.TrainState(m["jp"], jopt.init_adamw(m["jp"])),
                    start_step=0)
    tcfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    tr = Trainer(m["tm"], _Batches(batches, torch.as_tensor), tcfg,
                 TrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    tp = _tp()
    _, th = tr.run(start_state=TrainState(tp, topt.init_adamw(tp)))
    assert [s for s, _ in th] == [0, 1, 2]
    np.testing.assert_allclose([x["loss"] for _, x in th], [x["loss"] for _, x in jh],
                               atol=1e-4, rtol=0)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose([x[key] for _, x in th], [x[key] for _, x in jh],
                                   rtol=1e-4)
    assert all(x["step_time_s"] > 0 for _, x in th)


def test_grad_accumulation_matches_one_batch():
    """accum 2 against accum 1, on the loss and the gradients before the
    optimizer (AdamW would turn a 1e-7 gradient difference on a
    near-zero moment into ~1e-5 of a parameter, ROADMAP C)."""
    m = _models()
    batch = {"tokens": torch.as_tensor(np.concatenate([m["toks"], m["toks"][::-1]]))}
    l1, g1 = make_grad_fn(m["tm"], vocab_chunks=CHUNKS)(_tp(), batch)
    l2, g2 = make_grad_fn(m["tm"], vocab_chunks=CHUNKS, accum_steps=2)(_tp(), batch)
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
    for a, b in zip(topt.leaves(g2), topt.leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_grad_fn(m["tm"], accum_steps=3)(_tp(), batch)


def test_pipeline_batch_at_is_pure():
    data = SyntheticPipeline(DataConfig(vocab=512, seq_len=37, global_batch=3, seed=5))
    a, b = data.batch_at(4)["tokens"], data.batch_at(4)["tokens"]
    assert a.shape == (3, 37) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert not torch.equal(a, data.batch_at(5)["tokens"])
    assert not torch.equal(a, SyntheticPipeline(DataConfig(
        vocab=512, seq_len=37, global_batch=3, seed=6)).batch_at(4)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 512
    # repeat-4 base tokens with 10 % flips: most neighbours inside a group agree
    same = (a[:, 1:36:4] == a[:, 0:35:4]).float().mean().item()
    assert 0.7 < same < 0.95
    with pytest.raises(NotImplementedError, match="A14"):
        SyntheticPipeline(DataConfig(vocab=8, seq_len=4, global_batch=1,
                                     n_frontend_tokens=2))


def test_trainer_loop_hooks():
    cfg = reduced_config(ARCH)
    model = Model(cfg, device="cpu", dtype=torch.float32)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2))
    opt = topt.AdamWConfig(warmup_steps=1, total_steps=4)
    seen = []
    tr = Trainer(model, data, opt, TrainerConfig(total_steps=4, vocab_chunks=2))
    _, hist = tr.run(torch.Generator().manual_seed(0),
                     on_metrics=lambda s, mt: seen.append(s),
                     should_stop=lambda: len(seen) == 2)
    assert seen == [0, 1] and len(hist) == 2
    assert all(np.isfinite(x["loss"]) for _, x in hist)
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(model, data, opt, TrainerConfig(checkpoint_dir="ckpt"))
    with pytest.raises(ValueError, match="generator or a start state"):
        tr.run()
    tr._durations = [1.0] * 5
    tr._watchdog(7, 10.0)
    tr._watchdog(8, 1.2)
    assert [e["step"] for e in tr.straggler_events] == [7]


def test_train_cli_on_cpu():
    from repro_torch.launch.train import main

    hist = main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu", "--warp-backend", "sw"])
    assert len(hist) == 2 and all(np.isfinite(x["loss"]) for _, x in hist)
    with pytest.raises(NotImplementedError, match="A13"):
        main(["--arch", ARCH, "--device", "cpu", "--ckpt-dir", "ckpt"])
