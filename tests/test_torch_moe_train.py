"""Training the MoE family in the port against the reference on the CPU:
``MoEGating``'s backward against ``jax.vjp`` of the reference's
``gating_topk`` (ties, bf16 logits, rows that select fewer than k, NaN
rows), the loss and every parameter gradient of reduced OLMoE-1B-7B and
Granite-MoE against ``jax.value_and_grad`` of the reference's loss, and
three ``Trainer`` steps against the reference ``Trainer``, at the
config's capacity factor (which drops tokens at these shapes) and with
``moe_group_size=16``.  Reduced configs (4 layers, d 256, 8 experts,
top-4) in fp32; inputs from numpy with a seed, handed to both packages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.moe_gating.ops import moe_gating  # noqa: E402
from repro_torch.kernels.moe_gating.ref import moe_gating_ref  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.testing import expected_leaves, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.train.step import TrainState, make_loss_fn, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


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
# the gating gradient in f32: the same products w_i * (g_i - sum_j w_j g_j)
# that jax's chain rule through softmax and the renormalization takes in
# another order; |grad| <= ~2, so a few f32 ulps
GATE_GRAD_TOL = dict(atol=1e-6, rtol=0)
# bf16 logits: the f32 gradient rounded to bf16 once on each side, so at
# most one bf16 ulp (2^-8 relative) apart where the f32 values straddle a
# rounding boundary
GATE_GRAD_BF16_TOL = dict(atol=1e-6, rtol=2 ** -7)
# the model in fp32 through 4 layers, forward and backward
# (tests/test_torch_train.py's TOL): XLA and PyTorch order their sums
# differently (~1e-6 on values of magnitude ~1); a wrong routing, capacity
# or gating gradient moves them by > 1e-2
TOL = dict(atol=1e-5, rtol=1e-4)
SEQ, BATCH, CHUNKS = 16, 2, 4
_CACHE = {}


# ---------------------------------------------------------------------------
# the gating Function's backward
# ---------------------------------------------------------------------------

def _gating_case(name: str):
    """(logits (t, E) f32, top_k, dtype) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return rng.standard_normal((64, 8)).astype(np.float32), 2, torch.float32
    if name == "ties":           # integers: equal values across experts
        return np.round(rng.standard_normal((64, 16)) * 1.5).astype(np.float32), 4, torch.float32
    if name == "bf16":
        x = rng.standard_normal((64, 32)).astype(np.float32)
        return np.asarray(torch.tensor(x).bfloat16().float()), 8, torch.bfloat16
    if name == "fewer-than-k":   # rows with < k values above -1e30
        x = rng.standard_normal((16, 8)).astype(np.float32)
        x[0, 2:] = -1e30
        x[1, 1:] = -np.inf
        x[2, :5] = -1e30
        x[3, ::2] = -np.inf
        return x, 4, torch.float32
    if name == "olmoe":          # 64 experts, top-8
        return rng.standard_normal((128, 64)).astype(np.float32), 8, torch.float32
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "ties", "bf16", "fewer-than-k", "olmoe"])
def test_gating_backward_matches_jax_vjp(name):
    x, k, dtype = _gating_case(name)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    (want_w, want_m), vjp = jax.vjp(lambda a: jax_moe.gating_topk(a, k), jx)
    (want,) = vjp((jnp.asarray(g), jnp.zeros(want_m.shape, jax.dtypes.float0)))
    t = torch.tensor(x).to(dtype).requires_grad_()
    w, m = moe_gating(t, k)
    (w * torch.as_tensor(g)).sum().backward()
    assert torch.equal(m.bool(), torch.as_tensor(np.array(want_m)))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want_w), atol=1e-6, rtol=0)
    assert t.grad.dtype == dtype
    tol = GATE_GRAD_BF16_TOL if dtype == torch.bfloat16 else GATE_GRAD_TOL
    np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(want, np.float32), **tol)
    # autograd through the plain version itself: the same gradient
    p = torch.tensor(x).to(dtype).requires_grad_()
    (moe_gating_ref(p, k)[0] * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(t.grad.float().numpy(), p.grad.float().numpy(), **tol)


def test_gating_backward_on_rows_without_finite_weights():
    """Rows with no finite weight, beside finite rows, against ``jax.grad``
    of the reference's ``gating_topk``, NaN positions included: a NaN row
    selects nothing and gets an all-zero gradient (the reference's
    ``where`` zeroes every unselected lane); an all -inf row selects lane
    0, whose weight 0 / 0 is NaN, and gets NaN there and 0 elsewhere;
    finite rows are unchanged."""
    x = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    x[1, 3] = np.nan
    x[2] = -np.inf
    want = np.asarray(jax.grad(lambda a: jax_moe.gating_topk(a, 2)[0].sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    w, m = moe_gating(t, 2)
    w.sum().backward()
    assert m[1].sum() == 0 and torch.isnan(w[1]).all()
    assert m[2].tolist() == [1] + [0] * 7
    np.testing.assert_allclose(t.grad.numpy(), want, **GATE_GRAD_TOL)   # NaNs where jax's
    assert (t.grad[1] == 0).all()
    assert torch.isnan(t.grad[2, 0]) and (t.grad[2, 1:] == 0).all()
    for r in (0, 3):
        assert torch.isfinite(t.grad[r]).all() and torch.isfinite(w[r]).all()


# ---------------------------------------------------------------------------
# the model: loss and every gradient, the Trainer
# ---------------------------------------------------------------------------

def _models(arch, group=0):
    key = (arch, group)
    if key not in _CACHE:
        jcfg = dataclasses.replace(jax_reduced_config(arch), moe_group_size=group)
        tcfg = dataclasses.replace(reduced_config(arch), moe_group_size=group)
        jm = JaxModel(jcfg, compute_dtype=jnp.float32, param_dtype=jnp.float32)
        np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
        _CACHE[key] = dict(jm=jm, np=np_params, tcfg=tcfg,
                           tm=Model(tcfg, device="cpu", dtype=torch.float32))
    return _CACHE[key]


def _tp(m):
    return params_from_numpy(m["np"], m["tcfg"], device="cpu")


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _drops(cfg, toks, model, params):
    """Token-expert picks the reference's capacity drops in the first
    layer of a forward (so the cases exercise dropping)."""
    from repro_torch.models import moe

    seen = []
    gating = moe.gating_topk
    moe.gating_topk = lambda *a: seen.append(gating(*a)) or seen[-1]
    try:
        with torch.no_grad():
            model.forward(params, {"tokens": torch.as_tensor(toks)})
    finally:
        moe.gating_topk = gating
    mask = seen[0][1]
    g = cfg.moe_group_size
    if g and toks.shape[1] > g:
        mask = mask.reshape(-1, g, mask.shape[-1])
    cap = max(int(mask.shape[1] * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    return int((mask & (torch.cumsum(mask.int(), 1) > cap)).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_reference(arch):
    """The loss and every parameter gradient of the reduced MoE model
    against jax.value_and_grad of the reference's loss (its gating the
    jnp gating_topk), the port's through MoEGating; and the plain path
    (use_kernels=False: autograd through moe_gating_ref) gives the same."""
    m = _models(arch)
    toks = np.random.default_rng(11).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    assert _drops(m["tcfg"], toks, m["tm"], _tp(m)) > 0      # capacity 1.25 drops here
    loss_fn = jstep.make_loss_fn(m["jm"], vocab_chunks=CHUNKS)
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, m["np"]), {"tokens": jnp.asarray(toks)})
    want = jax.tree.map(np.asarray, want)
    plain = Model(m["tcfg"], device="cpu", dtype=torch.float32, use_kernels=False)
    for model in (m["tm"], plain):
        loss, grads = value_and_grad(make_loss_fn(model, vocab_chunks=CHUNKS))(
            _tp(m), {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
        got = to_numpy(grads)
        for path in expected_leaves(m["tcfg"]):
            np.testing.assert_allclose(_leaf(got, path), _leaf(want, path), **TOL,
                                       err_msg=f"{path} (use_kernels={model.use_kernels})")
        assert np.abs(_leaf(got, "layers.moe.router")).max() > 1e-4


class _Batches:
    def __init__(self, batches, conv):
        self.batches, self.conv = batches, conv

    def batch_at(self, step):
        return {"tokens": self.conv(self.batches[step])}


@pytest.mark.parametrize("arch,group,seq", [("olmoe-1b-7b", 0, 16),
                                            ("granite-moe-1b-a400m", 0, 16),
                                            ("granite-moe-1b-a400m", 16, 32)],
                         ids=["olmoe", "granite", "granite-group16"])
def test_trainer_losses_match_reference(arch, group, seq):
    """Three Trainer steps from the same weights on the same batches: the
    losses, lr and grad norms agree (tests/test_torch_train.py's
    tolerances), so the gating gradients and two AdamW updates carried
    over; group 16 splits each 32-token sequence into two dispatch
    groups."""
    m = _models(arch, group)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 512, (BATCH, seq)).astype(np.int32) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, m["np"])
    jtr = JaxTrainer(m["jm"], _Batches(batches, jnp.asarray),
                     jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                     JaxTrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    _, jh = jtr.run(None, start_state=jstep.TrainState(jp, jopt.init_adamw(jp)), start_step=0)
    tr = Trainer(m["tm"], _Batches(batches, torch.as_tensor),
                 topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                 TrainerConfig(total_steps=3, vocab_chunks=CHUNKS))
    tp = _tp(m)
    _, th = tr.run(start_state=TrainState(tp, topt.init_adamw(tp)))
    assert [s for s, _ in th] == [0, 1, 2]
    np.testing.assert_allclose([x["loss"] for _, x in th], [x["loss"] for _, x in jh],
                               atol=1e-4, rtol=0)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose([x[key] for _, x in th], [x[key] for _, x in jh],
                                   rtol=1e-4)
