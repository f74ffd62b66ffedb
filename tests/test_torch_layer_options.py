"""The layer options of the ported families (ROADMAP A6d) against the
reference on the CPU: ``pad_vocab_to`` (embed rows and head columns
padded; every logits site trims to the vocabulary, the loss masks the
padding), ``pv_bf16`` (the plain attention path contracts P with V in
bf16) and ``tie_embeddings`` (no ``lm_head``; ``embed.T`` is the head).

The counterpart of the reference's
``test_launch_integration.py::test_optimized_variant_preserves_semantics``
runs on reduced OLMoE at the reference's settings (``pad_vocab_to`` 256,
``moe_group_size`` 16, capacity factor 8), and again at ``pad_vocab_to``
384: the reduced vocabulary (512) is a multiple of 256, so only the
second case pads (512 -> 768).  Beside it: a tied and a padded model's
forward, loss and every gradient; sampled serving with a padded head; a
tied model's checkpoint manifest.  Weights come from the reference
(``params_from_numpy``).  fp32."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    adamw_state_from_numpy,
    expected_leaves,
    params_from_numpy,
    to_numpy,
)
from repro_torch.train.step import TrainState, make_loss_fn, value_and_grad  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small torch ops; one intra-op thread keeps them fast on a
    loaded CPU (as ``test_torch_sampling.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference's tolerance for the exact variants, and for pv_bf16 against
# the fp32 function (logits track; greedy decisions agree on > 95 %)
EXACT = dict(rtol=1e-4, atol=1e-4)
PV_BF16_VS_FP32 = dict(rtol=0.5, atol=0.5)
# the port's pv_bf16 against the reference's pv_bf16: both packages round
# the same fp32 P and V to bf16 and sum the products in fp32, so they part
# only by the order of fp32 sums (1.8e-6 on these inputs, a logit scale of
# 3.6) and by any bf16 rounding such an order moves; 1e-3 admits a few of
# those (one bf16 ulp is 2^-8 of a value) and nothing coarser
PV_BF16_VS_REFERENCE = dict(rtol=1e-3, atol=1e-3)
_CACHE = {}


def _pad_params(params, pad: int):
    """The reference test's padding: zero rows of embed, zero columns of
    lm_head (numpy leaves)."""
    return dict(params, embed=np.pad(params["embed"], ((0, pad), (0, 0))),
                lm_head=np.pad(params["lm_head"], ((0, 0), (0, pad))))


def _olmoe():
    """The reference test's model: reduced OLMoE at capacity factor 8 (no
    drop, so grouping is exact), its params (numpy) and batch."""
    if "olmoe" not in _CACHE:
        jcfg = dataclasses.replace(jax_reduced_config("olmoe-1b-7b"), capacity_factor=8.0)
        base = JaxModel(jcfg, compute_dtype=jnp.float32)
        params = jax.tree.map(np.asarray, base.init(jax.random.PRNGKey(0)))
        batch = SyntheticPipeline(DataConfig(vocab=jcfg.vocab, seq_len=32,
                                             global_batch=2, seed=0)).batch_at(0)
        ref = np.asarray(base.forward(params, batch))
        _CACHE["olmoe"] = (jcfg, params, batch, ref)
    return _CACHE["olmoe"]


def _port_cfg(jcfg, **changes):
    return dataclasses.replace(reduced_config(jcfg.name), capacity_factor=jcfg.capacity_factor,
                               **changes)


@pytest.mark.parametrize("pad_to", [256, 384])
def test_optimized_variant_preserves_semantics(pad_to):
    """Grouping + vocab padding: the port's padded, grouped forward gives
    the reference's unpadded logits and its own padded ones within 1e-4,
    trimmed to the vocabulary.  pv_bf16 (the plain attention path): the
    port's logits against the reference's pv_bf16 logits within
    ``PV_BF16_VS_REFERENCE``, against the fp32 function within the
    reference test's 0.5, with > 95 % argmax agreement."""
    jcfg, params, batch, ref = _olmoe()
    tokens = torch.as_tensor(np.array(batch["tokens"]))
    exact = dict(pad_vocab_to=pad_to, moe_group_size=16)
    jexact = dataclasses.replace(jcfg, **exact)
    pad = jexact.vocab_padded - jcfg.vocab
    assert pad == (0 if pad_to == 256 else 256)
    params_o = _pad_params(params, pad)
    want_padded = np.asarray(JaxModel(jexact, compute_dtype=jnp.float32).forward(
        jax.tree.map(jnp.asarray, params_o), batch))
    pcfg = _port_cfg(jcfg, **exact)
    assert pcfg.vocab_padded == jexact.vocab_padded
    tparams = params_from_numpy(params_o, pcfg, device="cpu")
    assert tparams["embed"].shape[0] == tparams["lm_head"].shape[1] == pcfg.vocab_padded
    got = Model(pcfg, device="cpu", dtype=torch.float32).forward(tparams, {"tokens": tokens})
    assert got.shape == ref.shape                     # trimmed back to the vocabulary
    np.testing.assert_allclose(got.numpy(), ref, **EXACT)
    np.testing.assert_allclose(got.numpy(), want_padded, **EXACT)

    jbf = dataclasses.replace(jcfg, pv_bf16=True)
    want_bf = np.asarray(JaxModel(jbf, compute_dtype=jnp.float32).forward(params, batch))
    bcfg = _port_cfg(jcfg, pv_bf16=True)
    got_bf = Model(bcfg, device="cpu", dtype=torch.float32, use_kernels=False).forward(
        params_from_numpy(params, bcfg, device="cpu"), {"tokens": tokens}).numpy()
    np.testing.assert_allclose(got_bf, want_bf, **PV_BF16_VS_REFERENCE)
    np.testing.assert_allclose(got_bf, ref, **PV_BF16_VS_FP32)
    assert np.mean(got_bf.argmax(-1) == ref.argmax(-1)) > 0.95
    assert np.mean(got_bf.argmax(-1) == want_bf.argmax(-1)) > 0.95
    # the kernel route ignores pv_bf16, as the reference's does: its
    # wrappers' plain versions on the CPU give the fp32 function
    got_kernel = Model(bcfg, device="cpu", dtype=torch.float32).forward(
        params_from_numpy(params, bcfg, device="cpu"), {"tokens": tokens}).numpy()
    np.testing.assert_allclose(got_kernel, ref, **EXACT)


def _dense(tie: bool, pad_to: int):
    """Reduced qwen2 with the options, both packages' models and the
    reference's params (numpy)."""
    key = ("dense", tie, pad_to)
    if key not in _CACHE:
        jcfg = dataclasses.replace(jax_reduced_config("qwen2-1.5b"), tie_embeddings=tie,
                                   pad_vocab_to=pad_to)
        jm = JaxModel(jcfg, compute_dtype=jnp.float32)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
        pcfg = dataclasses.replace(reduced_config("qwen2-1.5b"), tie_embeddings=tie,
                                   pad_vocab_to=pad_to)
        _CACHE[key] = (jcfg, jm, params, pcfg, Model(pcfg, device="cpu",
                                                     dtype=torch.float32))
    return _CACHE[key]


OPTIONS = {"tied": (True, 0), "padded": (False, 384), "tied-padded": (True, 384)}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_forward_loss_and_grads_match_reference(case):
    """Tied and padded dense models: the leaves are the reference's (no
    ``lm_head`` when tied; ``vocab_padded`` rows and columns), and the
    forward logits, the vocab-chunked loss (padding masked) and every
    gradient equal the reference's within 1e-4 (the tied embed's gradient
    sums its lookup's and the head's)."""
    tie, pad_to = OPTIONS[case]
    jcfg, jm, params, pcfg, tm = _dense(tie, pad_to)
    assert ("lm_head" in params) == (not tie)
    assert params["embed"].shape[0] == pcfg.vocab_padded
    assert tuple(sorted(expected_leaves(pcfg))) == tuple(sorted(
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]))
    tparams = params_from_numpy(params, pcfg, device="cpu")
    batch = SyntheticPipeline(DataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=2,
                                         seed=1)).batch_at(0)
    tbatch = {"tokens": torch.as_tensor(np.array(batch["tokens"]))}
    want = np.asarray(jm.forward(params, batch))
    got = tm.forward(tparams, tbatch)
    assert got.shape[-1] == jcfg.vocab
    np.testing.assert_allclose(got.detach().numpy(), want, **EXACT)
    jloss, jgrads = jax.value_and_grad(jstep.make_loss_fn(jm, vocab_chunks=4))(
        jax.tree.map(jnp.asarray, params), batch)
    tloss, tgrads = value_and_grad(make_loss_fn(tm, vocab_chunks=4))(tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), **EXACT)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    got_np = to_numpy(tgrads)
    for path, g in flat_want.items():
        node = got_np
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), err_msg=str(path), **EXACT)


def test_sampled_serving_with_padded_head_matches_reference():
    """A padded head (512 -> 768 columns, the reference's random pad
    columns included) serves the reference's sampled tokens (T 0.8, the
    paged layout's captured-step path): the sampler draws over the
    vocabulary's 512 columns only."""
    jcfg, jm, params, pcfg, tm = _dense(False, 384)
    kw = dict(max_seq=48, batch_slots=2, temperature=0.8, seed=5, cache_layout="paged",
              page_size=8)
    rng = np.random.default_rng(6)
    spec = [(i, rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
             int(rng.integers(3, 8))) for i in range(4)]
    want = JaxServeEngine(jm, jax.tree.map(jnp.asarray, params), **kw).serve(
        [JaxRequest(u, list(p), n) for u, p, n in spec])
    eng = ServeEngine(tm, params_from_numpy(params, pcfg, device="cpu"), **kw)
    got = eng.serve([Request(u, list(p), n) for u, p, n in spec])
    assert got == want
    assert all(0 <= t < jcfg.vocab for v in got.values() for t in v)


def test_tied_padded_checkpoint_follows_the_tree(tmp_path):
    """A tied, padded model's checkpoint: no ``.params/lm_head`` key, a
    ``vocab_padded``-row embed, and the manifest's bytes equal to the
    reference's for the same state."""
    jcfg, jm, params, pcfg, tm = _dense(True, 384)
    rng = np.random.default_rng(2)
    m = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    v = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32), params)
    jstate = jstep.TrainState(jax.tree.map(jnp.asarray, params), jopt.AdamWState(
        step=jnp.asarray(3, jnp.int32), m=jax.tree.map(jnp.asarray, m),
        v=jax.tree.map(jnp.asarray, v)))
    tstate = TrainState(params_from_numpy(params, pcfg, device="cpu"),
                        adamw_state_from_numpy(3, m, v, pcfg, device="cpu"))
    port_dir = tckpt.save_checkpoint(str(tmp_path / "port"), 4, tstate)
    ref_dir = jckpt.save_checkpoint(str(tmp_path / "ref"), 4, jstate)
    with open(os.path.join(port_dir, tckpt.MANIFEST), "rb") as f:
        port_manifest = f.read()
    with open(os.path.join(ref_dir, tckpt.MANIFEST), "rb") as f:
        assert f.read() == port_manifest
    keys = np.load(os.path.join(port_dir, tckpt.ARRAYS)).files
    assert not any("lm_head" in k for k in keys)
    assert np.load(os.path.join(port_dir, tckpt.ARRAYS))[
        ".params__embed"].shape == (pcfg.vocab_padded, pcfg.d_model)
