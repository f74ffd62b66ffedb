"""The port's checkpoints against the reference's on the CPU: the manifest
codec byte for byte against ``msgpack.packb`` (edge values and real
manifests), checkpoints written by either package restored by the other
(every leaf and the step equal, the manifests' bytes equal), the
reference's committed training resumed and continued by the port, the
reference's fault-tolerance tests replayed on the port (resume exact:
``torch.equal`` on the final state), the commit rules (``.tmp`` folders,
pruning, checksums, shapes), the async writer (its snapshot taken before
an in-place step, errors raised again), the trainer's checkpoint hooks,
the train CLI's resume and ``repro_torch.train_lm``'s restart drill."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.checkpoint import _manifest_codec as codec  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.testing import adamw_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.train.step import TrainState, init_train_state  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# the reference's test_fault_tolerance.py and test_train_serve.py models
TINY_FT = dict(name="tiny-ft", family="dense", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=64, vocab=128)
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256)
# reduced MiniCPM3-4B cut to 2 layers (both packages' reduced_config):
# an MLA train state, whose attention leaves are the latent projections
MLA = dict(name="minicpm3-4b", family="dense", n_layers=2, d_model=256, n_heads=4,
           n_kv_heads=4, d_ff=512, vocab=512, attn_type="mla", q_lora_rank=64,
           kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
# the recurrent families' train states (both packages' reduced configs,
# cut): RWKV6 at 2 layers (its layers' "tm" tree of time- and channel-mix
# leaves), Zamba2 at one group of 6 Mamba2 layers behind its shared block
SSM = dict(name="rwkv6-7b", family="ssm", n_layers=2, d_model=256, n_heads=0,
           n_kv_heads=0, d_ff=512, vocab=512, attn_type="none", rwkv_head_size=32)
HYBRID = dict(name="zamba2-2.7b", family="hybrid", n_layers=6, d_model=256, n_heads=4,
              n_kv_heads=4, d_ff=512, vocab=512, ssm_state=16, ssm_expand=2,
              ssm_head_dim=32, ssm_conv=4, hybrid_attn_every=6)
SPECS = [TINY, MLA, SSM, HYBRID]
SPEC_IDS = ["dense", "mla", "ssm", "hybrid"]
SEQ, BATCH = 16, 2
_CACHE = {}


def _port_model(spec=TINY):
    return Model(ModelConfig(**spec), device="cpu", dtype=torch.float32)


def _states(spec=TINY):
    """A mid-run state (step 3, nonzero moments) as numpy, and the same
    state in each package."""
    key = spec["name"]
    if key not in _CACHE:
        jm = JaxModel(JaxModelConfig(**spec, max_seq=32), compute_dtype=jnp.float32)
        # jitted: one compile, where the eager init compiles each draw's shape
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(2)))
        rng = np.random.default_rng(1)
        m = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        v = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32), params)
        _CACHE[key] = dict(jm=jm, np=(params, m, v))
    params, m, v = _CACHE[key]["np"]
    cfg = ModelConfig(**spec)
    jstate = jstep.TrainState(jax.tree.map(jnp.asarray, params), jopt.AdamWState(
        step=jnp.asarray(3, jnp.int32), m=jax.tree.map(jnp.asarray, m),
        v=jax.tree.map(jnp.asarray, v)))
    tstate = TrainState(params_from_numpy(params, cfg, device="cpu"),
                        adamw_state_from_numpy(3, m, v, cfg, device="cpu"))
    return _CACHE[key]["jm"], jstate, tstate


def _assert_state_equal(a: TrainState, b: TrainState):
    assert a.opt.step == b.opt.step and isinstance(a.opt.step, int)
    for (pa, x), (pb, y) in zip(tckpt._paths(a), tckpt._paths(b)):
        assert pa == pb
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), pa


# ---------------------------------------------------------------------------
# the manifest codec
# ---------------------------------------------------------------------------

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]
STR_EDGES = ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256, "d" * 65535, "e" * 65536,
             "é" * 20, ".opt/.m/layers/attn/wq"]
EDGES = (INT_EDGES + STR_EDGES
         + [0.0, -0.0, 1.5, -2.25e-300, float("inf"), float("-inf"), float("nan"),
            np.float64(0.1), True, False, None,
            [], list(range(15)), list(range(16)), list(range(65536)), (1, 2),
            {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
            {f"k{i}": [i, -i] for i in range(65536)},
            {"step": 7, "metadata": {"loss": 2.5, "preempted": True},
             "arrays": {".opt/.step": {"shape": [], "dtype": "int32",
                                       "checksum": "0123456789abcdef"}}}])


def _edge_id(x):
    r = repr(x)
    return r if len(r) < 24 else f"{type(x).__name__}-{len(x)}"


@pytest.mark.parametrize("value", EDGES, ids=[_edge_id(x) for x in EDGES])
def test_codec_bytes_equal_msgpack(value):
    got = codec.packb(value)
    assert got == msgpack.packb(value)
    back = codec.unpackb(got)
    assert back == msgpack.unpackb(got) or (value != value)      # NaN != NaN
    if isinstance(value, float) and value != value:
        assert back != back


@pytest.mark.parametrize("value", [b"raw", bytearray(b"x"), np.int64(3), np.float32(1.0),
                                   {1, 2}, object(), {"a": np.int32(1)}, [np.bool_(True)]],
                         ids=["bytes", "bytearray", "np.int64", "np.float32", "set",
                              "object", "np.int32-in-map", "np.bool_-in-list"])
def test_codec_refuses_what_a_manifest_never_holds(value):
    with pytest.raises(TypeError):
        codec.packb(value)
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)


def test_codec_refuses_data_a_manifest_never_holds():
    for raw in (msgpack.packb(1.5, use_single_float=True), msgpack.packb(b"\x00" * 300)):
        with pytest.raises(ValueError, match="not a manifest's"):
            codec.unpackb(raw)
    with pytest.raises(ValueError, match="after"):
        codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb("a" * 40)[:-1])


def test_codec_on_real_manifests(tmp_path):
    """The reference's own manifest decodes to what msgpack decodes, and
    encodes back to its bytes; the port's manifest of the same state is
    the same bytes."""
    _, jstate, tstate = _states()
    meta = {"loss": 3.140625, "preempted": True}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 12, jstate, metadata=meta)
    tckpt.save_checkpoint(str(tmp_path / "port"), 12, tstate, metadata=meta)
    raw = (tmp_path / "ref" / "step_00000012" / "manifest.msgpack").read_bytes()
    decoded = codec.unpackb(raw)
    assert decoded == msgpack.unpackb(raw)
    assert codec.packb(decoded) == raw == msgpack.packb(decoded)
    assert (tmp_path / "port" / "step_00000012" / "manifest.msgpack").read_bytes() == raw
    assert list(decoded["arrays"])[:2] == [".params/embed", ".params/layers/attn/wk"]
    assert ".opt/.step" in decoded["arrays"] and decoded["metadata"] == meta


# ---------------------------------------------------------------------------
# one layout: either package restores the other's checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_port_checkpoint_restores_in_reference(tmp_path, spec):
    """The port's checkpoint of a mid-run state restores in the reference,
    every leaf and the step equal, in JAX's flatten order; its manifest is
    the reference's bytes for the same state."""
    jm, jstate, tstate = _states(spec)
    meta = {"loss": 1.0, "preempted": False}
    tckpt.save_checkpoint(str(tmp_path / "port"), 5, tstate, metadata=meta)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, jstate, metadata=meta)
    manifest = os.path.join("step_00000005", "manifest.msgpack")
    assert ((tmp_path / "port" / manifest).read_bytes()
            == (tmp_path / "ref" / manifest).read_bytes())
    like = jax.tree.map(jnp.zeros_like, jstate)       # the tree, its shapes and dtypes
    got, step, meta = jckpt.restore_checkpoint(str(tmp_path / "port"), like)
    assert step == 5 and meta == {"loss": 1.0, "preempted": False}
    assert got.opt.step.dtype == jnp.int32 and int(got.opt.step) == 3
    want = jax.tree_util.tree_leaves(jstate)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(want) == len(list(tckpt._paths(tstate)))
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_reference_checkpoint_restores_in_port(tmp_path, spec):
    _, jstate, tstate = _states(spec)
    jckpt.save_checkpoint(str(tmp_path), 5, jstate, metadata={"loss": 2.0})
    like = init_train_state(_port_model(spec), torch.Generator().manual_seed(9))
    got, step, meta = tckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 5 and meta == {"loss": 2.0}
    _assert_state_equal(got, tstate)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in topt.leaves(got.params))


class _Batches:
    """A pipeline stub: the same numpy batches for both packages."""

    def __init__(self, batches, conv):
        self.batches, self.conv = batches, conv

    def batch_at(self, step):
        return {"tokens": self.conv(self.batches[step])}


def test_port_resumes_the_references_training(tmp_path):
    """The reference trains 4 steps and commits; the port restores that
    checkpoint and trains steps 4-7; its losses are the reference's
    uninterrupted run's, within test_trainer_losses_match_reference's
    tolerances (tests/test_torch_train.py)."""
    ckpt = str(tmp_path / "ck")
    jm, _, _ = _states()
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, TINY["vocab"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(8)]
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    key = jax.random.PRNGKey(0)
    _, full = JaxTrainer(jm, _Batches(batches, jnp.asarray), jcfg,
                         JaxTrainerConfig(total_steps=8, vocab_chunks=1)).run(key)
    JaxTrainer(jm, _Batches(batches, jnp.asarray), jcfg, JaxTrainerConfig(
        total_steps=4, checkpoint_every=4, checkpoint_dir=ckpt, vocab_chunks=1)).run(key)
    tcfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    tr = Trainer(_port_model(), _Batches(batches, torch.as_tensor), tcfg,
                 TrainerConfig(total_steps=8, checkpoint_every=100, checkpoint_dir=ckpt,
                               vocab_chunks=1))
    _, hist = tr.run(torch.Generator().manual_seed(1))
    assert [s for s, _ in hist] == [4, 5, 6, 7]
    want = full[4:]
    np.testing.assert_allclose([x["loss"] for _, x in hist], [x["loss"] for _, x in want],
                               atol=1e-4, rtol=0)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose([x[k] for _, x in hist], [x[k] for _, x in want],
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the reference's fault-tolerance tests, replayed on the port
# ---------------------------------------------------------------------------

def _trainer(tmp=None, total=10, every=3, spec=TINY_FT, seed=4, **kw):
    """tests/test_fault_tolerance.py's ``_trainer`` on the port."""
    model = _port_model(spec)
    data = SyntheticPipeline(DataConfig(vocab=spec["vocab"], seq_len=16,
                                        global_batch=2, seed=seed))
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=kw.pop("opt_total", total))
    return Trainer(model, data, opt, TrainerConfig(
        total_steps=total, checkpoint_every=every, checkpoint_dir=tmp,
        vocab_chunks=1, **kw))


def test_straggler_watchdog_flags_slow_steps():
    tr = _trainer()
    for step, dt in enumerate([0.1] * 10):
        tr._watchdog(step, dt)
    assert not tr.straggler_events
    tr._watchdog(10, 1.0)  # 10x the median
    assert len(tr.straggler_events) == 1
    ev = tr.straggler_events[0]
    assert ev["step"] == 10 and ev["duration"] == 1.0


def test_preemption_checkpoints_and_resumes_exactly(tmp_path):
    ckpt = str(tmp_path / "ck")
    full, ref_hist = _trainer(None, total=8, every=100).run(torch.Generator().manual_seed(0))
    tr = _trainer(ckpt, total=8, every=100)
    fired = {"n": 0}

    def should_stop():
        fired["n"] += 1
        return fired["n"] == 5  # after the 5th step (step index 4)

    _, hist1 = tr.run(torch.Generator().manual_seed(0), should_stop=should_stop)
    assert hist1[-1][0] == 4  # stopped early
    assert tckpt.latest_step(ckpt) == 5
    _, _, meta = tckpt.restore_checkpoint(ckpt, init_train_state(
        tr.model, torch.Generator().manual_seed(0)))
    assert meta == {"loss": hist1[-1][1]["loss"], "preempted": True}
    resumed, hist2 = _trainer(ckpt, total=8, every=100).run(torch.Generator().manual_seed(0))
    assert hist2[0][0] == 5  # resumed, not restarted
    np.testing.assert_allclose(ref_hist[-1][1]["loss"], hist2[-1][1]["loss"], rtol=1e-5)
    assert [m["loss"] for _, m in hist2] == [m["loss"] for _, m in ref_hist[5:]]
    _assert_state_equal(resumed, full)


def test_pipeline_stateless_determinism():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=4, seed=11)
    a = SyntheticPipeline(cfg).batch_at(123)["tokens"]
    b = SyntheticPipeline(cfg).batch_at(123)["tokens"]
    assert torch.equal(a, b)
    c = SyntheticPipeline(cfg).batch_at(124)["tokens"]
    assert not torch.equal(a, c)


def test_async_checkpointer_commits_and_resumes(tmp_path):
    ckpt, ckpt2 = str(tmp_path / "ck_async"), str(tmp_path / "ck_sync")
    kw = dict(total=6, every=2, keep_checkpoints=2)
    tr = _trainer(ckpt, async_checkpoint=True, **kw)
    final, _ = tr.run(torch.Generator().manual_seed(0))
    assert tr._async_ckpt.last_write_s > 0
    _trainer(ckpt2, **kw).run(torch.Generator().manual_seed(0))
    assert tckpt.latest_step(ckpt) == tckpt.latest_step(ckpt2) == 6
    assert sorted(os.listdir(ckpt)) == sorted(os.listdir(ckpt2)) == [
        "step_00000004", "step_00000006"]
    like = init_train_state(tr.model, torch.Generator().manual_seed(0))
    a, _, _ = tckpt.restore_checkpoint(ckpt, like)
    b, _, _ = tckpt.restore_checkpoint(ckpt2, like)
    _assert_state_equal(a, b)
    _assert_state_equal(a, final)
    tr._async_ckpt.close()


def test_checkpoint_restart_exact(tmp_path):
    """tests/test_train_serve.py::test_checkpoint_restart_exact on the
    port: 5 steps into one folder, then a trainer asked for 10 resumes at
    5; its final loss and state are the uninterrupted run's."""
    full, hist_full = _trainer(str(tmp_path / "ck"), total=10, every=5, spec=TINY,
                               seed=2).run(torch.Generator().manual_seed(0))
    ckpt2 = str(tmp_path / "ck2")
    _trainer(ckpt2, total=5, every=5, spec=TINY, seed=2, opt_total=10).run(
        torch.Generator().manual_seed(0))
    resumed, hist = _trainer(ckpt2, total=10, every=5, spec=TINY, seed=2).run(
        torch.Generator().manual_seed(0))
    assert hist[0][0] == 5  # resumed, not restarted
    np.testing.assert_allclose(hist_full[-1][1]["loss"], hist[-1][1]["loss"], rtol=1e-5)
    _assert_state_equal(resumed, full)


# ---------------------------------------------------------------------------
# commit rules
# ---------------------------------------------------------------------------

def test_uncommitted_folders_are_skipped_and_pruning_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    _, _, tstate = _states()
    assert tckpt.latest_step(d + "/missing") is None
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(d, step, tstate)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))          # a writer killed mid-save
    (tmp_path / "step_00000009.tmp" / "manifest.msgpack").write_bytes(b"\x80")
    os.makedirs(os.path.join(d, "step_00000008"))              # no manifest
    assert tckpt.latest_step(d) == 4
    tckpt.prune_old(d, keep=2)
    assert sorted(n for n in os.listdir(d) if not n.endswith(".tmp")) == [
        "step_00000004", "step_00000008"]
    assert tckpt.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "empty"), tstate)


def test_corrupted_array_and_wrong_shape_raise(tmp_path):
    _, _, tstate = _states()
    path = tckpt.save_checkpoint(str(tmp_path), 1, tstate)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    arrays[".params__ln_f"] = arrays[".params__ln_f"] + 1.0
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with pytest.raises(IOError, match="checksum mismatch for .params/ln_f"):
        tckpt.restore_checkpoint(str(tmp_path), tstate)
    tckpt.save_checkpoint(str(tmp_path), 2, tstate)
    cfg = ModelConfig(**{**TINY, "d_ff": 96})
    like = init_train_state(Model(cfg, device="cpu", dtype=torch.float32),
                            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="w_down: checkpoint shape"):
        tckpt.restore_checkpoint(str(tmp_path), like)


def test_restore_takes_the_dtype_of_tree_like_and_bf16_is_refused(tmp_path):
    _, _, tstate = _states()
    with pytest.raises(TypeError, match="params/embed: numpy cannot hold"):
        tckpt.save_checkpoint(str(tmp_path), 1, {"params": {"embed": torch.zeros(
            2, dtype=torch.bfloat16)}})
    assert tckpt.latest_step(str(tmp_path)) is None
    tckpt.save_checkpoint(str(tmp_path), 1, tstate)
    like = tstate._replace(params=topt.tree_map(lambda t: t.double(), tstate.params))
    got, _, _ = tckpt.restore_checkpoint(str(tmp_path), like)
    assert all(t.dtype == torch.float64 for t in topt.leaves(got.params))
    assert torch.equal(got.params["embed"], tstate.params["embed"].double())


# ---------------------------------------------------------------------------
# the async writer
# ---------------------------------------------------------------------------

def test_async_snapshot_is_taken_before_an_in_place_step(tmp_path, monkeypatch):
    """save(), then an in-place update of every leaf before the writer
    runs: the committed arrays are the state at save() (a CPU tensor's
    .numpy() would alias the live storage)."""
    _, _, tstate = _states()
    snapshot = topt.tree_map(torch.clone, tstate.params)
    gate, write = threading.Event(), tckpt._write_snapshot

    def held(*args):
        assert gate.wait(30)
        return write(*args)

    monkeypatch.setattr(tckpt, "_write_snapshot", held)
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(7, tstate, metadata={"loss": 0.5, "preempted": False})
    with torch.no_grad():
        for p in topt.leaves(tstate.params):
            p.add_(1.0)
    gate.set()
    ck.wait()
    got, step, meta = tckpt.restore_checkpoint(str(tmp_path), tstate)
    assert step == 7 and meta["loss"] == 0.5
    for a, b in zip(topt.leaves(got.params), topt.leaves(snapshot)):
        assert torch.equal(a, b)
    assert not torch.equal(got.params["embed"], tstate.params["embed"])
    ck.close()


def test_async_writer_errors_are_raised_on_the_next_call(tmp_path, monkeypatch):
    _, _, tstate = _states()

    def broken(*args):
        raise OSError("disk full")

    write = tckpt._write_snapshot
    monkeypatch.setattr(tckpt, "_write_snapshot", broken)
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(1, tstate)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    monkeypatch.setattr(tckpt, "_write_snapshot", write)
    ck.save(2, tstate)
    ck.close()
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert not ck._thread.is_alive()


# ---------------------------------------------------------------------------
# the train_lm example's restart drill
# ---------------------------------------------------------------------------

def test_train_lm_restart_drill(tmp_path, capsys):
    from repro_torch.train_lm import DEMO_100M, main

    assert (DEMO_100M.n_layers, DEMO_100M.d_model, DEMO_100M.n_heads, DEMO_100M.n_kv_heads,
            DEMO_100M.d_ff, DEMO_100M.vocab, DEMO_100M.qkv_bias) == (
        12, 768, 12, 4, 2048, 32000, True)
    ckpt = tmp_path / "ck"
    out = main(["--steps", "4", "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt", str(ckpt)], cfg=ModelConfig(**{**TINY, "qkv_bias": True}))
    assert [s for s, _ in out["history"]] == [0, 1, 2, 3]
    assert out["resumed_at"] == 4 and [s for s, _ in out["resumed"]] == [4, 5, 6, 7]
    assert all(np.isfinite(m["loss"]) for _, m in out["history"] + out["resumed"])
    assert "resumed at step 4" in capsys.readouterr().out
    assert not ckpt.exists()
