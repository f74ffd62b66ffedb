"""The port's PR transformation (``repro_torch.core.pr_transform``) on the
CPU against the reference's (``repro.core.pr_transform``) on the same
programs and inputs: the reference test's eight tests (paper §IV, Fig. 3/4)
through the port's ``hw``, ``kernel`` and ``sw`` executors, the memory and
divergence edges the two packages must share, the ``kernel`` lowering's
static routing, and the quickstart and Table IV counterparts.

Each program is built once by a factory of
``repro_torch.bench.pr_transform_bench`` for each package (its
``Namespace`` carries the IR, dtypes and cast).  The port's ``hw`` and
``kernel`` paths are held to the reference's ``run_hw``, its ``sw`` path
to ``run_sw``: exactly, f32 sums within rtol 1e-6.  Each reference output
is computed once per module (every ``run_sw`` compiles its loops)."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ir as jax_ir  # noqa: E402
from repro.core.pr_transform import run as ref_run  # noqa: E402
from repro.core.pr_transform import transform_report as ref_report  # noqa: E402
from repro.core.warp import WarpConfig as RefWarpConfig  # noqa: E402
from repro_torch.bench import pr_transform_bench as bench  # noqa: E402
from repro_torch.core import ir  # noqa: E402
from repro_torch.core import pr_transform as pr  # noqa: E402
from repro_torch.core.warp import WarpConfig  # noqa: E402

JAX = bench.Namespace(ir=jax_ir, WarpConfig=RefWarpConfig, int32=jnp.int32,
                      float32=jnp.float32, bool_=jnp.bool_,
                      cast=lambda x, dtype: x.astype(dtype))
WARP = (8, 4)           # the paper's evaluation config (the reference test's)
SUM_TOL = dict(rtol=1e-6, atol=0.0)
# the reference test's seed for each of its programs; the others take 11
SEEDS = {"fig3": 0, "if_else": 4, "smem_reduce": 5, "tile_reconfig": 7}
PORT_PATH_OF_REF = {"hw": "hw", "kernel": "hw", "sw": "sw"}


_KINDS = {k for k, _ in bench.REFERENCE_KINDS + bench.MORE_KINDS}


def _seed(name: str) -> int:
    """The reference test's seed; 6 for its collective kinds, else 11."""
    return SEEDS.get(name, 6 if name.split()[0] in _KINDS else 11)


def _inp(seed, n):
    """The reference test's input: n values in [0, 2) from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"inp": rng.uniform(0, 2, size=(n,)).astype(np.float32)}


def _inputs(case, seed, n):
    return _inp(seed, n) if case.takes_input else {}


@functools.lru_cache(maxsize=None)
def reference(name: str, block: tuple, seed: int, path: str):
    case = bench.CASES[name]
    prog = case.make(JAX, RefWarpConfig(*block))
    x = {k: jnp.asarray(v) for k, v in _inputs(case, seed, prog.block_size).items()}
    return {k: np.asarray(v) for k, v in ref_run(prog, x, path).items()}


def port(name: str, block: tuple, seed: int, path: str):
    case = bench.CASES[name]
    prog = case.make(bench.TORCH, WarpConfig(*block))
    out = pr.run(prog, _inputs(case, seed, prog.block_size), path, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def assert_matches_reference(name: str, block=WARP, seed=None):
    """The port's three paths against the reference's path of their kind;
    returns the port's outputs by path."""
    case = bench.CASES[name]
    seed = _seed(name) if seed is None else seed
    outs = {}
    for path, ref_path in PORT_PATH_OF_REF.items():
        want = reference(name, block, seed, ref_path)
        got = port(name, block, seed, path)
        assert set(got) == set(want), path
        for k, w in want.items():
            msg = f"{name} {block} {path} vs reference {ref_path}: {k}"
            if k in case.sums:
                np.testing.assert_allclose(got[k], w, err_msg=msg, **SUM_TOL)
            else:
                assert got[k].dtype == w.dtype, msg
                np.testing.assert_array_equal(got[k], w, err_msg=msg)
        outs[path] = got
    return outs


# ---------------------------------------------------------------------------
# The reference test's eight tests (tests/test_pr_transform.py), ported
# ---------------------------------------------------------------------------

def test_fig3_hw_equals_sw():
    outs = assert_matches_reference("fig3")
    for k in ("groupId", "gtid", "x", "r", "out"):
        for path in ("kernel", "sw"):
            np.testing.assert_array_equal(outs[path][k], outs["hw"][k], err_msg=k)


def test_fig3_vote_scoped_to_tile_and_predicate():
    outs = assert_matches_reference("fig3", seed=3)
    for path, out in outs.items():
        x, r = out["x"], out["r"]
        # only group 0 (tids 0..3) participates; its vote is any(x[0:4] > 2)
        assert (r[0:4] == (x[0:4] > 2.0).any()).all(), path
        assert not r[4:].any(), path  # non-participating lanes never written


def test_fig3_transform_report():
    rep = pr.transform_report(bench.fig3(bench.TORCH, WarpConfig(*WARP)))
    want = ref_report(bench.fig3(JAX, RefWarpConfig(*WARP)))
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    # paper Fig. 4: two serialised loops, one nested-loop collective, the
    # if fissioned across the vote boundary
    assert (rep.n_regions_serialized, rep.n_collectives, rep.n_fissioned_ifs) == (2, 1, 1)


def test_if_else_fission():
    outs = assert_matches_reference("if_else")
    inp = _inputs(bench.CASES["if_else"], 4, 32)["inp"]
    tid = np.arange(32)
    expect = np.where(tid % 2 == 0, (inp + 1) * 3, (inp - 1) * 5)
    for out in outs.values():
        np.testing.assert_allclose(out["b"], expect, rtol=1e-6)


def test_special_variable_rewrite():
    outs = assert_matches_reference("special_vars")
    np.testing.assert_array_equal(outs["hw"]["t"], np.arange(32))
    for k in ("t", "w", "l"):
        np.testing.assert_array_equal(outs["sw"][k], outs["hw"][k])


def test_shared_memory_store_load():
    outs = assert_matches_reference("smem_reduce")
    inp = _inputs(bench.CASES["smem_reduce"], 5, 32)["inp"].reshape(4, 8)
    for out in outs.values():
        np.testing.assert_allclose(out["total"], outs["hw"]["total"], rtol=1e-5)
        np.testing.assert_allclose(out["smem"], inp.sum(-1), rtol=1e-5)


@pytest.mark.parametrize("kind,params", bench.REFERENCE_KINDS,
                         ids=[k for k, _ in bench.REFERENCE_KINDS])
def test_every_collective_kind_hw_eq_sw(kind, params):
    outs = assert_matches_reference(bench.kind_name(kind, params))
    for path in ("kernel", "sw"):
        np.testing.assert_allclose(outs[path]["r"], outs["hw"]["r"], rtol=1e-6)


def test_tile_reconfiguration_sequence():
    outs = assert_matches_reference("tile_reconfig")
    inp = _inputs(bench.CASES["tile_reconfig"], 7, 32)["inp"]
    for out in outs.values():
        np.testing.assert_allclose(out["r4"], np.repeat(inp.reshape(8, 4).sum(-1), 4),
                                   rtol=1e-5)
        np.testing.assert_allclose(out["r8"], np.repeat(inp.reshape(4, 8).sum(-1), 8),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# The rest of the catalog and the edges, each against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [bench.kind_name(k, p) for k, p in bench.MORE_KINDS])
def test_more_collective_kinds_match_reference(name):
    assert_matches_reference(name)


@pytest.mark.parametrize("block", [(8, 1), WARP])
def test_load_wraps_negative_index_then_clamps(block):
    outs = assert_matches_reference("load_edges", block)
    inp = _inputs(bench.CASES["load_edges"], 11, block[0] * block[1])["inp"]
    tid = np.arange(block[0] * block[1])
    for out in outs.values():
        # Load(buf[4], t - 2): lanes 0 and 1 read slots 2 and 3
        np.testing.assert_array_equal(out["neg"][:2], inp[2:4])
        np.testing.assert_array_equal(out["past"], inp[np.minimum(tid + 2, 3)])
        np.testing.assert_array_equal(out["far"][0], inp[0])   # -9 -> -5 -> 0


def test_store_past_the_end_drops_on_hw_and_clamps_on_sw():
    outs = assert_matches_reference("oob_store", (8, 1))
    inp = _inputs(bench.CASES["oob_store"], 11, 8)["inp"]
    # Store(buf[4], t + 2): HW keeps [0, 0, v0, v1], SW clamps to [0, 0, v0, v7]
    for path in ("hw", "kernel"):
        np.testing.assert_array_equal(outs[path]["buf"], [0, 0, inp[0], inp[1]])
        # -t - 5 wraps once to -t - 1, still negative: every lane drops
        assert not outs[path]["low"].any()
    np.testing.assert_array_equal(outs["sw"]["buf"], [0, 0, inp[0], inp[7]])
    np.testing.assert_array_equal(outs["sw"]["low"], [inp[7], 0, 0, 0])  # clamped to 0


@pytest.mark.parametrize("block", [(8, 1), WARP])
def test_duplicate_store_indices_highest_active_tid_wins(block):
    outs = assert_matches_reference("dup_store", block)
    n = block[0] * block[1]
    inp = _inputs(bench.CASES["dup_store"], 11, n)["inp"]
    winner = [max(t for t in range(n - 2) if t % 4 == k) for k in range(4)]
    for out in outs.values():
        np.testing.assert_array_equal(out["buf"], inp[winner])


def test_serialised_region_carries_state():
    outs = assert_matches_reference("carry")
    inp = _inputs(bench.CASES["carry"], 11, 32)["inp"]
    for path in ("hw", "kernel"):
        assert not outs[path]["prev"].any()          # the block before the region
    np.testing.assert_array_equal(outs["sw"]["prev"][1:], inp[:-1])  # lane t - 1's store
    assert outs["sw"]["prev"][0] == 0


@pytest.mark.parametrize("block", [WARP, (32, 4)])
def test_vote_uni_and_ballot_with_lane0_inactive(block):
    outs = assert_matches_reference("lane0_inactive", block)
    n = block[0] * block[1]
    inp = _inputs(bench.CASES["lane0_inactive"], 11, n)["inp"]
    val = ((np.arange(n) % 4 == 0) | (inp > 1.6)).reshape(-1, 4)
    members_uni = (val[:, 1:] == val[:, 1:2]).all(-1)
    lane0_uni = (val == val[:, :1]).all(-1)
    assert (members_uni != lane0_uni).any()   # the data tells the two rules apart
    for out in outs.values():
        u = out["u"].reshape(-1, 4)
        np.testing.assert_array_equal(u[:, 1:], np.repeat(members_uni[:, None], 3, 1))


def test_ballot_into_f32_and_int32_targets_with_the_top_bit_set():
    block = (32, 4)
    outs = assert_matches_reference("lane0_inactive", block)
    bits = (_inp(11, 128)["inp"] > 1.0).reshape(4, 32)
    bits &= np.arange(32) % 4 != 0
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    assert (words >= 2 ** 31).any()       # lane 31 voted in some warp
    active = np.arange(32) % 4 != 0
    for out in outs.values():
        bf, bi = out["bf"].reshape(4, 32), out["bi"].reshape(4, 32)
        for w in range(4):
            assert (bf[w][active] == np.float32(words[w])).all()
            assert (bi[w][active] == words[w].astype(np.uint32).view(np.int32)).all()


@pytest.mark.parametrize("name", ["int_reduce", "shfl_words"])
def test_integer_and_bool_words_match_reference(name):
    assert_matches_reference(name)


def test_shfl_xor_mask_at_least_segment_keeps_own_value(monkeypatch):
    """The shfl wrapper refuses mask >= width; the executor returns the
    operand unchanged, as the reference's hw_backend does, and launches
    nothing."""
    calls = _spy(monkeypatch)
    prog = bench.collective("shfl_xor", {"mask": 8})(bench.TORCH, WarpConfig(*WARP))
    inp = _inp(11, 32)
    out = pr.run(prog, inp, "kernel", device="cpu")
    np.testing.assert_array_equal(out["r"].numpy(), inp["inp"])
    assert sum(calls.values()) == 0
    want = ref_run(bench.collective("shfl_xor", {"mask": 8})(JAX, RefWarpConfig(*WARP)),
                   {"inp": jnp.asarray(inp["inp"])}, "hw")
    np.testing.assert_array_equal(out["r"].numpy(), np.asarray(want["r"]))


# ---------------------------------------------------------------------------
# The kernel lowering's static routing
# ---------------------------------------------------------------------------

def _spy(monkeypatch):
    calls = {"shfl": 0, "vote": 0, "tile_reduce": 0}
    for name in calls:
        real = getattr(pr, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(pr, name, spy)
    return calls


def _bf16(env, tid, ctx):
    return env["inp"].to(torch.bfloat16)


def _i32(env, tid, ctx):
    return (env["inp"] * 100).to(torch.int32)


def _pred(env, tid, ctx):
    return env["inp"] > 1.0


def _f32(env, tid, ctx):
    return env["inp"]


ROUTES = [
    # kind, params, operand, warp, expected wrapper
    ("shfl_up", {"delta": 2}, _f32, WARP, "shfl"),
    ("shfl_down", {"delta": 3}, _i32, WARP, "shfl"),
    ("shfl_xor", {"mask": 1}, _pred, WARP, "shfl"),
    ("shfl_xor", {"mask": 8}, _f32, WARP, "none"),
    ("shfl_idx", {"src_lane": 3}, _f32, WARP, "shfl"),
    ("shfl_idx", {"src_lane": torch.tensor([7, 6, 5, 4, 3, 2, 1, 0])}, _f32, WARP,
     "hw_backend"),
    ("shfl_up", {"delta": 1}, _bf16, WARP, "hw_backend"),
    ("vote_all", {}, _pred, WARP, "vote"),
    ("vote_any", {}, _f32, WARP, "vote"),
    ("vote_uni", {}, _i32, WARP, "vote"),
    ("vote_ballot", {}, _pred, WARP, "vote"),
    ("vote_ballot", {}, _pred, (64, 1), "hw_backend"),
    ("warp_reduce", {"op": "sum"}, _f32, WARP, "tile_reduce"),
    ("warp_reduce", {"op": "max"}, _i32, WARP, "tile_reduce"),
    ("warp_reduce", {"op": "min"}, _bf16, WARP, "tile_reduce"),
    ("warp_reduce", {"op": "prod"}, _f32, WARP, "hw_backend"),
    ("warp_reduce", {"op": "or"}, _i32, WARP, "hw_backend"),
    ("warp_reduce", {"op": "sum"}, _pred, WARP, "hw_backend"),
    ("warp_scan", {"op": "sum"}, _f32, WARP, "hw_backend"),
]


@pytest.mark.parametrize("kind,params,operand,block,route", ROUTES,
                         ids=[f"{k}-{o.__name__}-{b[0]}-{r}"
                              for k, _, o, b, r in ROUTES])
def test_kernel_route_reaches_the_named_wrapper_only(monkeypatch, kind, params, operand,
                                                     block, route):
    warp = WarpConfig(*block)
    prog = ir.ThreadProgram(
        warp=warp, locals={"r": torch.float32},
        stmts=[ir.If(lambda env, tid, ctx: tid % 3 != 1,
                     [ir.Collective("r", kind, operand, params)])])
    inp = _inp(12, warp.block_size)
    dtype = operand(pr.EnvView({"inp": torch.from_numpy(inp["inp"])}), None, None).dtype
    assert pr.kernel_route(kind, params, dtype, warp.warp_size) == route
    calls = _spy(monkeypatch)
    got = pr.run(prog, inp, "kernel", device="cpu")
    assert calls == {k: int(k == route) for k in calls}
    want = pr.run(prog, inp, "hw", device="cpu")
    assert torch.equal(got["r"], want["r"])


def test_every_catalog_program_agrees_across_lowerings_on_the_cpu():
    """The smoke's gates, on the CPU at both block sizes."""
    bench.check_all(seed=0, device="cpu")


# ---------------------------------------------------------------------------
# Device, inputs, entry points
# ---------------------------------------------------------------------------

def test_run_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = bench.special_vars(bench.TORCH, WarpConfig(*WARP))
    for path in pr.PATHS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pr.run(prog, {}, path)
    with pytest.raises(ValueError, match="unknown path"):
        pr.run(prog, {}, "tpu", device="cpu")


@pytest.mark.parametrize("path", pr.PATHS)
def test_inputs_are_copied_and_never_written(path):
    prog = ir.ThreadProgram(
        warp=WarpConfig(*WARP), locals={},
        stmts=[ir.Assign("inp", lambda env, tid, ctx: env["inp"] + 1.0),
               ir.Assign("n", lambda env, tid, ctx: env["n"] * 2)])
    x = torch.arange(32, dtype=torch.float32)
    n = np.arange(32)                            # int64: narrowed to int32
    out = pr.run(prog, {"inp": x, "n": n}, path, device="cpu")
    assert torch.equal(x, torch.arange(32, dtype=torch.float32))
    assert (n == np.arange(32)).all()
    assert torch.equal(out["inp"], x + 1.0)
    assert out["n"].dtype == torch.int32 and torch.equal(out["n"], torch.arange(32, dtype=torch.int32) * 2)


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch import quickstart

    r = quickstart.main(device="cpu")
    assert r["hw_equals_sw"] and r["kernel_equals_hw"] and r["shfl_matches_plain"]
    # the example's Figure-3 kernel has no store: one serialised loop
    assert dataclasses.astuple(r["report"]) == (5, 1, 1, 1)
    assert "done." in capsys.readouterr().out


def test_table4_overhead_on_the_cpu():
    from repro_torch.bench import table4_overhead as t4

    r = t4.run(device="cpu")
    site, model = r["site_aten_ops"], r["model_aten_ops"]
    assert site["plain"] < site["hw_warp"] < site["sw"]
    assert model["hw"] < model["hw_warp"] < model["sw"]
    assert model["kernel"] == model["hw"]         # the wrapper's plain version
    for key in ("site_hw_overhead_pct", "site_sw_overhead_pct", "model_hw_overhead_pct",
                "model_sw_overhead_pct"):
        assert r[key] > 0
    assert r["paper_overhead_pct"] == 2.0
    assert r["device"] == "cpu"
    assert r["site_launches"] is None and r["model_launches"] is None
    assert r["footprint"] is None
    assert t4.format_lines(r)
