"""Training MLA attention (MiniCPM3-4B) in the port against the reference
on the CPU: the loss and every parameter gradient against
``jax.value_and_grad`` of the reference's loss (its attention through the
Pallas flash kernels in interpret mode, the port's through
``FlashAttention`` at D = nope + rope over Dv = v_head_dim), remat against
no remat, one AdamW step against the reference's ``make_train_step``,
three ``Trainer`` steps against the reference ``Trainer``, and the train
CLI.  Reduced MiniCPM3 cut to 2 layers, as the reference's ``small_cfg``
(d_model 256, 4 heads, q rank 64, kv rank 32, q/k heads of 32 nope + 16
rope dims, v heads of 32, vocab 512) in fp32; inputs from numpy with a
seed, handed to both packages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    MLA_ATTN,
    expected_leaves,
    params_from_numpy,
    to_numpy,
)
from repro_torch.train.step import (  # noqa: E402
    TrainState,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port's reduced models run many small torch ops; on a loaded CPU
    (the suite's parallel workers) intra-op threads wait at every op's
    barrier, so the module runs on one thread and restores the count
    after (as ``test_torch_train.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "minicpm3-4b"
LAYERS = 2
# the model in fp32, forward and backward (tests/test_torch_train.py's
# TOL): XLA and PyTorch block their matmuls and reductions differently
# (~1e-6 on values of magnitude ~1); a wrong mask, rope, norm eps or
# concatenation moves them by > 1e-2
TOL = dict(atol=1e-5, rtol=1e-4)
# one AdamW step from zero moments moves each weight by lr * g / (|g| +
# eps) (lr 1e-3, eps 1e-8) and its decay.  Where the reference's |g| >=
# STEP_G_MIN (1e3 eps) gradients that agree to TOL move a weight alike to
# ~1e-8 (its own fp32 rounding: 1.2e-7 at ln1's weights of ~1); nearer 0,
# g / (|g| + eps) turns a 1e-9 gradient difference into ~1e-1 of lr, so
# there each side's update is only held to its bound, lr
STEP_TOL = dict(atol=2e-7, rtol=1e-6)
STEP_G_MIN = 1e-5
STEP_LR = 1e-3
SEQ, BATCH, CHUNKS = 16, 2, 4
_CACHE = {}


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _models():
    """Reference (attention through the Pallas kernels in interpret mode)
    and port on the same weights, and one numpy batch."""
    if not _CACHE:
        jcfg = dataclasses.replace(jax_reduced_config(ARCH), n_layers=LAYERS)
        tcfg = dataclasses.replace(reduced_config(ARCH), n_layers=LAYERS)
        jm = JaxModel(jcfg, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                      attn_backend="kernel")
        jp = jm.init(jax.random.PRNGKey(5))
        toks = np.random.default_rng(6).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
        _CACHE.update(jm=jm, jp=jp, np=jax.tree.map(np.asarray, jp), toks=toks, tcfg=tcfg,
                      tm=Model(tcfg, device="cpu", dtype=torch.float32))
    return _CACHE


def _tp():
    """A fresh copy of the bridged weights (the port's steps update them
    in place)."""
    m = _models()
    return params_from_numpy(m["np"], m["tcfg"], device="cpu")


def _jax_loss_and_grads():
    m = _models()
    if "jloss" not in m:
        loss_fn = jstep.make_loss_fn(m["jm"], vocab_chunks=CHUNKS)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            m["jp"], {"tokens": jnp.asarray(m["toks"])})
        m.update(jloss=float(loss), jgrads=jax.tree.map(np.asarray, grads))
    return m["jloss"], m["jgrads"]


def _port_loss_and_grads(model):
    return value_and_grad(make_loss_fn(model, vocab_chunks=CHUNKS))(
        _tp(), {"tokens": torch.as_tensor(_models()["toks"])})


def test_mla_leaves_are_the_references():
    """The bridged tree holds the reference's leaves, MLA's attention
    among them, at its shapes (q/k heads of nope + rope, v heads)."""
    m = _models()
    paths = expected_leaves(m["tcfg"])
    assert set(MLA_ATTN) <= set(paths) and "layers.attn.wq" not in paths
    tp = _tp()
    for path in paths:
        assert tuple(_leaf(tp, path).shape) == _leaf(m["np"], path).shape, path
    c = m["tcfg"]
    assert _leaf(tp, "layers.attn.q_up").shape == (
        LAYERS, c.q_lora_rank, c.n_heads * (c.qk_nope_head_dim + c.qk_rope_head_dim))
    assert _leaf(tp, "layers.attn.kv_down").shape == (
        LAYERS, c.d_model, c.kv_lora_rank + c.qk_rope_head_dim)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_and_every_grad_match_reference(attn):
    """The loss and every parameter gradient (q_down, q_norm, q_up,
    kv_down, kv_norm, kv_up, wo and the rest) against jax.value_and_grad
    of the reference's loss.  ``kernel``: the port's FlashAttention
    Function (the flash backward's plain version at D 48 / Dv 32) and the
    latent norms' RMSNorm Function; ``plain``: autograd through the plain
    versions (``use_kernels=False``).  k_rope is one head broadcast over
    all, so kv_down's rope columns take the gradient summed over heads."""
    m = _models()
    want_loss, want = _jax_loss_and_grads()
    model = m["tm"] if attn == "kernel" else Model(m["tcfg"], device="cpu",
                                                   dtype=torch.float32, use_kernels=False)
    loss, grads = _port_loss_and_grads(model)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    got = to_numpy(grads)
    for path in expected_leaves(m["tcfg"]):
        np.testing.assert_allclose(_leaf(got, path), _leaf(want, path), **TOL, err_msg=path)
    for path in MLA_ATTN:
        assert np.abs(_leaf(got, path)).max() > 1e-6, path
    kr = m["tcfg"].kv_lora_rank
    assert np.abs(_leaf(got, "layers.attn.kv_down")[..., kr:]).max() > 1e-6   # rope part


def test_remat_and_no_remat_give_the_same_gradients():
    """Remat changes what is kept, not what is computed: the recomputed
    layers repeat the same ops on the same values, so the gradients are
    equal bit for bit."""
    m = _models()
    loss_r, g_r = _port_loss_and_grads(m["tm"])
    loss_n, g_n = _port_loss_and_grads(Model(m["tcfg"], device="cpu", dtype=torch.float32,
                                             remat=False))
    assert m["tm"].remat and loss_r.item() == loss_n.item()
    a, b = to_numpy(g_r), to_numpy(g_n)
    for path in expected_leaves(m["tcfg"]):
        np.testing.assert_array_equal(_leaf(a, path), _leaf(b, path), err_msg=path)


def test_one_optimizer_step_matches_reference():
    """One full optimizer step (forward, flash backward, AdamW) against the
    reference's ``make_train_step`` on the same weights and batch: the
    loss, and every updated leaf within STEP_TOL where the reference's
    gradient is at least STEP_G_MIN (all but 0.3 % of the weights with a
    nonzero gradient), within 2 lr elsewhere."""
    m = _models()
    jcfg = jopt.AdamWConfig(lr=STEP_LR, warmup_steps=1, total_steps=4)
    jstate = jstep.TrainState(m["jp"], jopt.init_adamw(m["jp"]))
    jnew, jmetrics = jax.jit(jstep.make_train_step(m["jm"], jcfg, vocab_chunks=CHUNKS))(
        jstate, {"tokens": jnp.asarray(m["toks"])})
    want = jax.tree.map(np.asarray, jnew.params)
    _, jgrads = _jax_loss_and_grads()
    tp = _tp()
    step = make_train_step(m["tm"], topt.AdamWConfig(lr=STEP_LR, warmup_steps=1,
                                                     total_steps=4), vocab_chunks=CHUNKS)
    new, metrics = step(TrainState(tp, topt.init_adamw(tp)),
                        {"tokens": torch.as_tensor(m["toks"])})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **TOL)
    assert new.opt.step == int(jnew.opt.step) == 1
    got = to_numpy(new.params)
    for path in expected_leaves(m["tcfg"]):
        a, w = _leaf(got, path), _leaf(want, path)
        big = np.abs(_leaf(jgrads, path)) >= STEP_G_MIN
        assert big.any(), path
        np.testing.assert_allclose(a[big], w[big], **STEP_TOL, err_msg=path)
        assert np.abs(a - w).max() <= 2 * STEP_LR, path
        assert not np.array_equal(a, _leaf(m["np"], path)), path      # it moved


class _Batches:
    """A pipeline stub: the same numpy batches for both packages."""

    def __init__(self, batches, conv):
        self.batches, self.conv = batches, conv

    def batch_at(self, step):
        return {"tokens": self.conv(self.batches[step])}


def test_trainer_losses_match_reference():
    """Three Trainer steps from the bridged weights on the same batches:
    the losses, lr and grad norms agree (tests/test_torch_train.py's
    tolerances), so the first step's gradients and two AdamW updates
    carried over."""
    m = _models()
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(3)]
    jtr = JaxTrainer(m["jm"], _Batches(batches, jnp.asarray),
                     jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                     JaxTrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    _, jh = jtr.run(None, start_state=jstep.TrainState(m["jp"], jopt.init_adamw(m["jp"])),
                    start_step=0)
    tr = Trainer(m["tm"], _Batches(batches, torch.as_tensor),
                 topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                 TrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    tp = _tp()
    _, th = tr.run(start_state=TrainState(tp, topt.init_adamw(tp)))
    assert [s for s, _ in th] == [0, 1, 2]
    np.testing.assert_allclose([x["loss"] for _, x in th], [x["loss"] for _, x in jh],
                               atol=1e-4, rtol=0)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose([x[key] for _, x in th], [x[key] for _, x in jh],
                                   rtol=1e-4)


def test_train_cli_on_cpu(capsys):
    """``launch.train --arch minicpm3-4b --device cpu``: the reduced
    config trains 2 steps to finite losses."""
    from repro_torch.launch.train import main

    hist = main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu"])
    assert [s for s, _ in hist] == [0, 1]
    assert all(np.isfinite(x["loss"]) for _, x in hist)
    assert "(minicpm3-4b," in capsys.readouterr().out


def test_train_cli_keeps_the_kernels_head_dims_on_the_card():
    """On the card the CLI's reduced MLA config keeps MiniCPM3's head dims,
    the (96, 64) pair the flash kernels are built for; the reduced
    config's (48, 32) has no instance.  Other configs are unchanged."""
    from repro_torch.configs.registry import get_config, with_kernel_head_dims
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    reduced = reduced_config(ARCH)
    card = with_kernel_head_dims(reduced)
    full = get_config(ARCH)
    assert (card.qk_nope_head_dim, card.qk_rope_head_dim, card.v_head_dim) == (
        full.qk_nope_head_dim, full.qk_rope_head_dim, full.v_head_dim)
    assert (card.qk_nope_head_dim + card.qk_rope_head_dim, card.v_head_dim) in HEAD_DIMS
    assert (reduced.qk_nope_head_dim + reduced.qk_rope_head_dim,
            reduced.v_head_dim) not in HEAD_DIMS
    assert dataclasses.replace(card, qk_nope_head_dim=reduced.qk_nope_head_dim,
                               qk_rope_head_dim=reduced.qk_rope_head_dim,
                               v_head_dim=reduced.v_head_dim) == reduced
    qwen = reduced_config("qwen2-1.5b")
    assert with_kernel_head_dims(qwen) is qwen
