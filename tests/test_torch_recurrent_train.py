"""Training RWKV6-7B (``family="ssm"``) and Zamba2-2.7B (``family="hybrid"``)
in the port against the reference on the CPU (ROADMAP A14c-train).

Reduced configs as both packages' ``reduced_config`` (RWKV6 cut to 2
layers: d_model 256, head size 32; Zamba2 at its 12 Mamba2 layers in 2
groups of 6 behind one shared block of 4 heads of 64, state 16, head dim
32), fp32, the reference's weights carried over by ``params_from_numpy``,
token batches from numpy with a seed.  The cases:
- ``tests/test_arch_smoke.py:45``'s train step on the port: a finite loss,
  finite gradients, gradients that reach the embedding;
- the loss and every parameter gradient against ``jax.value_and_grad`` of
  the reference's loss (its shared attention through the Pallas flash
  kernels in interpret mode), Zamba2 through the port's ``FlashAttention``
  Function and through autograd of the plain versions;
- remat against no remat; one AdamW step against ``make_train_step``;
  three ``Trainer`` losses against the reference ``Trainer``; the train
  CLI.
The scans' backward is autograd over the time loop, as the reference's is
``jax.grad`` of its ``lax.scan``.  The reference's compiled loss-and-grad
and train step are built once an arch (``ref``), and its ``Trainer`` steps
through that train step."""

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
from repro_torch.testing import expected_leaves, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainState,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The scans are many small torch ops; one intra-op thread keeps them
    fast on a loaded CPU (as ``test_torch_recurrent.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("rwkv6-7b", "zamba2-2.7b")
LAYERS = {"rwkv6-7b": 2, "zamba2-2.7b": 12}
# the model in fp32, forward and backward (test_torch_mla_train.py's TOL):
# XLA and PyTorch block their sums differently (~1e-6 on values of ~1)
TOL = dict(atol=1e-5, rtol=1e-4)
# one AdamW step from zero moments moves each weight by lr * u / (|u| +
# eps), u the clipped gradient (test_torch_mla_train.py's reasoning).
# Here the smallest gradients are cancellations that carry the 12 layers'
# fp32 noise, ~1e-6 absolute (the embedding's at Zamba2: -1.80e-5 against
# -1.72e-5), and clipping a global norm of ~48 to 1 scales eps up 48x
# against them: where the reference's |g| >= STEP_G_MIN a 1e-6 gradient
# difference moves the update by <= 5e-8; nearer 0 each side's update is
# only held to its bound, lr
STEP_TOL = dict(atol=2e-7, rtol=1e-6)
STEP_G_MIN = 1e-4
# one optimizer config for the AdamW step and the Trainer, so that the
# reference's Trainer steps through the train step compiled for the first
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
SEQ, BATCH, CHUNKS = 16, 2, 4


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _cfgs(arch):
    n = LAYERS[arch]
    return (dataclasses.replace(jax_reduced_config(arch), n_layers=n),
            dataclasses.replace(reduced_config(arch), n_layers=n))


def _tokens(seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(n)]


class _Ref:
    """One arch's reference: the model (attention through the Pallas
    kernels in interpret mode, remat as its default), weights from its
    jitted init, and its loss-and-grad and train step, each compiled
    once."""

    def __init__(self, arch):
        self.arch = arch
        jcfg, self.tcfg = _cfgs(arch)
        self.jm = JaxModel(jcfg, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                           attn_backend="kernel")
        self.jp = jax.jit(self.jm.init)(jax.random.PRNGKey(5))
        self.np = jax.tree.map(np.asarray, self.jp)
        self.toks = _tokens(6)[0]
        self.opt = jopt.AdamWConfig(**OPT)
        self.step = jax.jit(jstep.make_train_step(self.jm, self.opt, vocab_chunks=CHUNKS))
        self._grads = None

    def loss_and_grads(self):
        if self._grads is None:
            loss_fn = jstep.make_loss_fn(self.jm, vocab_chunks=CHUNKS)
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                self.jp, {"tokens": jnp.asarray(self.toks)})
            self._grads = float(loss), jax.tree.map(np.asarray, grads)
        return self._grads

    def tp(self):
        """A fresh copy of the bridged weights (the port's steps update
        them in place)."""
        return params_from_numpy(self.np, self.tcfg, device="cpu")

    def port(self, **kw):
        return Model(self.tcfg, device="cpu", dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _Ref(arch)
        return built[arch]

    return get


def _port_loss_and_grads(r, model):
    return value_and_grad(make_loss_fn(model, vocab_chunks=CHUNKS))(
        r.tp(), {"tokens": torch.as_tensor(r.toks)})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_no_nans(arch):
    """``tests/test_arch_smoke.py:45`` on the port: the reduced config at
    its full depth (remat off, as there), B 2 x S 32, the loss that test
    writes (log-softmax of ``forward``'s logits against the tokens rolled
    by one); a finite loss, finite gradients, and gradients that reach
    the embedding through every layer."""
    cfg = reduced_config(arch)
    model = Model(cfg, device="cpu", dtype=torch.float32, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 32)))

    def loss_fn(p, batch):
        logits = model.forward(p, batch)
        lp = torch.log_softmax(logits, dim=-1)
        labels = torch.roll(batch["tokens"], -1, dims=1)
        return -torch.gather(lp, -1, labels[..., None]).mean()

    loss, grads = value_and_grad(loss_fn)(params, {"tokens": tokens})
    assert torch.isfinite(loss)
    flat = topt.leaves(grads)
    assert all(torch.isfinite(g).all() for g in flat)
    assert sum(g.abs().sum().item() for g in flat) > 0
    assert grads["embed"].abs().sum() > 0
    # the first layer's mixer weights: the gradient crossed every layer
    first = grads["layers"]["tm"]["wr"] if arch == "rwkv6-7b" else \
        grads["layers"]["mamba"]["in_proj"]
    assert (first[0].abs().sum() > 0).item()


@pytest.mark.parametrize("arch,attn", [("rwkv6-7b", "kernel"), ("zamba2-2.7b", "kernel"),
                                       ("zamba2-2.7b", "plain")])
def test_loss_and_every_grad_match_reference(ref, arch, attn):
    """The loss and every parameter gradient (embed, the head, every
    mixer leaf: RWKV6's token-shift mixes, decay LoRA, bonus, ln_x and
    channel mix; Mamba2's in_proj, conv, A_log, D, dt_bias, norm and
    out_proj; Zamba2's shared block, which takes the sum over its 2
    groups) against jax.value_and_grad of the reference's loss.
    ``kernel``: the wrapper sites (Zamba2's attention through the
    ``FlashAttention`` Function, whose backward is the flash backward's
    plain version on the CPU; the norms through ``RMSNorm``); ``plain``:
    autograd through the plain versions (``use_kernels=False``)."""
    r = ref(arch)
    want_loss, want = r.loss_and_grads()
    model = r.port() if attn == "kernel" else r.port(use_kernels=False)
    loss, grads = _port_loss_and_grads(r, model)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    got = to_numpy(grads)
    for path in expected_leaves(r.tcfg):
        np.testing.assert_allclose(_leaf(got, path), _leaf(want, path), **TOL, err_msg=path)
        assert np.abs(_leaf(got, path)).max() > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_no_remat_give_the_same_gradients(ref, arch):
    """Remat changes what is kept, not what is computed: the recomputed
    layers (each scan's time loop again) repeat the same ops on the same
    values, so the gradients are equal bit for bit."""
    r = ref(arch)
    loss_r, g_r = _port_loss_and_grads(r, r.port())
    loss_n, g_n = _port_loss_and_grads(r, r.port(remat=False))
    assert r.port().remat and loss_r.item() == loss_n.item()
    a, b = to_numpy(g_r), to_numpy(g_n)
    for path in expected_leaves(r.tcfg):
        np.testing.assert_array_equal(_leaf(a, path), _leaf(b, path), err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_optimizer_step_matches_reference(ref, arch):
    """One optimizer step (forward, the scans' backward, AdamW) against the
    reference's ``make_train_step`` on the same weights and batch: the
    loss, and every updated leaf within STEP_TOL where the reference's
    gradient is at least STEP_G_MIN, within 2 lr elsewhere."""
    r = ref(arch)
    jnew, jmetrics = r.step(jstep.TrainState(r.jp, jopt.init_adamw(r.jp)),
                            {"tokens": jnp.asarray(r.toks)})
    want = jax.tree.map(np.asarray, jnew.params)
    _, jgrads = r.loss_and_grads()
    tp = r.tp()
    step = make_train_step(r.port(), topt.AdamWConfig(**OPT), vocab_chunks=CHUNKS)
    new, metrics = step(TrainState(tp, topt.init_adamw(tp)),
                        {"tokens": torch.as_tensor(r.toks)})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), **TOL)
    assert new.opt.step == int(jnew.opt.step) == 1
    got = to_numpy(new.params)
    lr = OPT["lr"]
    for path in expected_leaves(r.tcfg):
        a, w = _leaf(got, path), _leaf(want, path)
        big = np.abs(_leaf(jgrads, path)) >= STEP_G_MIN
        assert big.any(), path
        np.testing.assert_allclose(a[big], w[big], **STEP_TOL, err_msg=path)
        assert np.abs(a - w).max() <= 2 * lr, path
        assert not np.array_equal(a, _leaf(r.np, path)), path      # it moved


class _Batches:
    """A pipeline stub: the same numpy batches for both packages."""

    def __init__(self, batches, conv):
        self.batches, self.conv = batches, conv

    def batch_at(self, step):
        return {"tokens": self.conv(self.batches[step])}


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_losses_match_reference(ref, arch):
    """Three Trainer steps from the bridged weights on the same batches:
    the losses, lr and grad norms agree (tests/test_torch_train.py's
    tolerances), so the first step's gradients and two AdamW updates
    carried over.  The reference Trainer runs its loop over the train step
    that ``ref`` compiled for the same model and optimizer config."""
    r = ref(arch)
    batches = _tokens(9, 3)
    jtr = JaxTrainer(r.jm, _Batches(batches, jnp.asarray), r.opt,
                     JaxTrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    # its own step would be jax.jit(make_train_step(jm, opt, vocab_chunks,
    # accum_steps 1)): the one ref compiled
    assert jtr.opt_cfg == r.opt and (jtr.cfg.vocab_chunks, jtr.cfg.accum_steps) == (CHUNKS, 1)
    jtr._step = r.step
    _, jh = jtr.run(None, start_state=jstep.TrainState(r.jp, jopt.init_adamw(r.jp)),
                    start_step=0)
    tr = Trainer(r.port(), _Batches(batches, torch.as_tensor), topt.AdamWConfig(**OPT),
                 TrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    tp = r.tp()
    _, th = tr.run(start_state=TrainState(tp, topt.init_adamw(tp)))
    assert [s for s, _ in th] == [s for s, _ in jh] == [0, 1, 2]
    np.testing.assert_allclose([x["loss"] for _, x in th], [x["loss"] for _, x in jh],
                               atol=1e-4, rtol=0)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose([x[key] for _, x in th], [x[key] for _, x in jh],
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys):
    """``launch.train --arch rwkv6-7b|zamba2-2.7b --device cpu``: the
    reduced config trains 2 steps to finite losses."""
    from repro_torch.launch.train import main

    hist = main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu"])
    assert [s for s, _ in hist] == [0, 1]
    assert all(np.isfinite(x["loss"]) for _, x in hist)
    assert f"({arch}," in capsys.readouterr().out
