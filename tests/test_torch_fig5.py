"""The port's Figure 5 microbenchmarks on the CPU against the reference
benchmark (``benchmarks/fig5_microbench.py``) on the same inputs: each
benchmark's HW and SW lowerings within the reference's own 2e-4, and
``run``'s HW == SW check and row layout."""

import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.bench import fig5_microbench as fig5  # noqa: E402

N_BLOCKS = 64
TOL = dict(rtol=2e-4, atol=2e-4)


def _reference_bench():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "fig5_microbench.py")
    spec = importlib.util.spec_from_file_location("reference_fig5_microbench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_bench()


def test_configuration_matches_reference():
    assert fig5.WARP.warp_size == REF.WARP.warp_size == 8
    assert fig5.WARP.num_warps == REF.WARP.num_warps == 4
    assert fig5.TILE4.size == REF.TILE4.size == 4
    assert fig5.N_BLOCKS == REF.N_BLOCKS
    assert fig5.PAPER_BANDS == REF.PAPER_BANDS
    assert list(fig5.BENCHES) == list(REF.BENCHES)


@pytest.mark.parametrize("name", list(fig5.BENCHES))
@pytest.mark.parametrize("lowering", ["kernel", "hw", "sw"])
def test_lowering_matches_reference(name, lowering):
    """The port's kernel and hw lowerings against the reference's HW
    function, its sw lowering against the reference's SW function."""
    args = fig5.make_inputs(seed=3, device="cpu", n_blocks=N_BLOCKS)[name]
    ref_fn = REF.BENCHES[name]["make"]("sw" if lowering == "sw" else "hw")
    want = np.asarray(ref_fn(*(jnp.asarray(a.numpy()) for a in args)), np.float32)
    got = fig5.BENCHES[name]["make"](lowering)(*args)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, **TOL)


def test_run_on_cpu_checks_agreement_and_takes_no_time():
    rows = fig5.run(seed=0, device="cpu", n_blocks=N_BLOCKS)
    assert [r["bench"] for r in rows] == list(fig5.BENCHES) + ["GEOMEAN"]
    for r in rows[:-1]:
        assert r["device"] == "cpu"
        assert r["max_abs_err"] <= 2e-4
        # a CPU run is not a device measurement: no time is reported
        assert r["t_hw_us"] is r["t_hw_plain_us"] is r["t_sw_us"] is None
        assert r["hw_over_sw_speedup"] is None and r["in_band"] is None
    assert rows[-1]["hw_over_sw_speedup"] is None
    assert len(fig5.format_rows(rows)) == len(rows) + 1


def test_run_raises_when_a_lowering_disagrees(monkeypatch):
    broken = dict(fig5.BENCHES)
    make = fig5.bench_reduce
    broken["reduce"] = dict(broken["reduce"], make=lambda low: (
        (lambda x: make(low)(x) + 1.0) if low == "sw" else make(low)))
    monkeypatch.setattr(fig5, "BENCHES", broken)
    with pytest.raises(AssertionError, match="reduce: the sw lowering"):
        fig5.run(device="cpu", n_blocks=4)


def test_rows_carry_the_sw_over_hw_ratio_and_its_geomean():
    """What a card run reports, from given times: ratio = t_sw / t_kernel,
    the paper band test, and the geometric mean of the ratios."""
    rows = [fig5._row(name, {"kernel": 2.0, "hw": 3.0, "sw": 2.0 * s}, 0.0, "card")
            for name, s in zip(fig5.BENCHES, (4.0, 1.0, 9.0, 0.5, 2.0, 1.0))]
    assert [r["hw_over_sw_speedup"] for r in rows] == [4.0, 1.0, 9.0, 0.5, 2.0, 1.0]
    assert [r["in_band"] for r in rows] == [True, False, False, False, False, False]
    assert rows[1]["t_hw_plain_us"] == 3.0
    geo = fig5._geomean_row(rows)["hw_over_sw_speedup"]
    assert math.isclose(geo, (4.0 * 9.0 * 0.5 * 2.0) ** (1 / 6))
    assert fig5._geomean_row(rows + [fig5._row("vote", dict.fromkeys(fig5.LOWERINGS),
                                               0.0, "cpu")])["hw_over_sw_speedup"] is None
