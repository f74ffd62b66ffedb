"""The port's measured preemption cost model (``serve.calibrate``) and the
serving CLI (``repro_torch.launch.serve``).

The cost-model cases replay ``test_pipeline_overlap.py``'s calibration
cases (:237, :244, :254) on the port: the measured model's ``source``,
the wiring order (an explicit model wins, then ``preempt_calibrate``,
then the defaults), and ``preempt="auto"`` steered by the figures, whose
tokens and swap counts are held to the reference engine's on the same
inputs.  The CLI runs in-process through ``main([...])`` on the CPU, at
the reference CLI's reduced config, closed and open-loop, and through the
fleet (``--replicas``, ``--router``, ``--disaggregate``)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serve.calibrate import CostModel as JaxCostModel  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import calibrate  # noqa: E402
from repro_torch.serve.calibrate import (  # noqa: E402
    DEFAULT_COST_MODEL,
    CostModel,
)
from test_torch_scheduling import (  # noqa: E402
    jax_serve,
    models,
    one_intra_op_thread,
    port_engine,
    port_serve,
    reqs,
)


def test_calibrate_cost_model():
    m = models()
    cm = calibrate.calibrate(m["tm"], m["tp"], max_seq=32, repeats=1)
    assert cm.source == "measured"
    assert cm.swap_gbps > 0 and cm.decode_flops_s > 0


def test_measurements_score_bytes_and_parameters(monkeypatch):
    """The round trip counts 2 x nbytes, the decode step 2 x the parameters
    the reference counts, each over the best time (pinned here to 0.5 s);
    the timer runs the measured call each repeat."""
    m = models()
    calls = []

    def best(fn, repeats, device):
        calls.append((repeats, str(device)))
        fn()
        return 0.5

    monkeypatch.setattr(calibrate, "_best_seconds", best)
    assert calibrate.measure_swap_bandwidth(1 << 16, repeats=2, device="cpu") == 2 * (1 << 16) / 0.5
    n_params = sum(int(x.size) for x in jax.tree.leaves(m["jp"]))
    assert calibrate.measure_decode_flops_s(m["tm"], m["tp"], max_seq=16,
                                            repeats=4) == 2.0 * n_params / 0.5
    assert calls == [(2, "cpu"), (4, "cpu")]


def test_engine_cost_model_wiring():
    assert port_engine().cost_model == DEFAULT_COST_MODEL
    assert DEFAULT_COST_MODEL == CostModel(*map(float, (8e9, 5e10)))
    assert (DEFAULT_COST_MODEL.swap_gbps, DEFAULT_COST_MODEL.decode_flops_s) == (
        JaxCostModel(8e9, 5e10).swap_gbps, JaxCostModel(8e9, 5e10).decode_flops_s)
    explicit = CostModel(1e9, 1e12, source="explicit")
    assert port_engine(cost_model=explicit).cost_model is explicit
    # an explicit model wins over preempt_calibrate
    assert port_engine(cost_model=explicit, preempt_calibrate=True).cost_model is explicit
    measured = port_engine(preempt_calibrate=True).cost_model
    assert measured.source == "measured"
    assert measured.swap_gbps > 0 and measured.decode_flops_s > 0


def test_cost_model_steers_auto_preempt():
    """An infinitely fast link swaps, an infinitely fast model recomputes;
    either way the tokens are the reference's under the same model."""
    spec = reqs(6, mlo=6, mhi=12)
    swap_wins = dict(swap_gbps=1e15, decode_flops_s=1e3)
    want, _ = jax_serve(spec, num_pages=4, preempt="auto",
                        cost_model=JaxCostModel(**swap_wins))
    out, eng = port_serve(spec, num_pages=4, preempt="auto",
                          cost_model=CostModel(**swap_wins))
    assert eng.last_pool_stats.swap_outs > 0
    assert out == want
    out, eng = port_serve(spec, num_pages=4, preempt="auto",
                          cost_model=CostModel(swap_gbps=1e-3, decode_flops_s=1e15))
    assert eng.last_pool_stats.swap_outs == 0
    assert eng.preemptions > 0
    assert out == want


# ------------------------------------------------------------------- the CLI
CLI = ["--arch", "qwen2-1.5b", "--device", "cpu", "--requests", "4", "--prompt-len", "8",
       "--max-new", "5", "--max-seq", "48", "--slots", "2"]


def test_cli_closed_batch(capsys):
    out = serve_cli.main(CLI + ["--cache-layout", "paged", "--page-size", "8"])
    text = capsys.readouterr().out
    assert set(out["results"]) == {0, 1, 2, 3}
    assert all(len(v) == 5 for v in out["results"].values())
    assert out["sla"]["statuses"] == {"ok": 4}
    for line in ("SLA:", "ttft", "tbt", "goodput", "lifecycle: ok=4", "pool: "):
        assert line in text
    assert out["cost_model"] == DEFAULT_COST_MODEL


def test_cli_open_loop_round_clock(capsys):
    """``--workload poisson --clock round`` replays the arrivals through the
    streaming server; the tokens are a closed serve's of the same requests
    on the same engine; ``--preempt-calibrate`` prints the measured model."""
    out = serve_cli.main(CLI + ["--cache-layout", "paged", "--page-size", "8",
                                "--workload", "poisson", "--clock", "round",
                                "--preempt", "auto", "--preempt-calibrate"])
    text = capsys.readouterr().out
    assert "workload: poisson n=4" in text and "round clock" in text
    assert "calibrated cost model: swap" in text and "(measured, cpu)" in text
    assert "poisson open-loop" in text and "SLA:" in text
    assert out["cost_model"].source == "measured"
    assert out["sla"]["statuses"] == {"ok": 4}
    args = serve_cli.build_parser().parse_args(CLI + ["--workload", "poisson"])
    timed, reqs_ = serve_cli._requests(args, models()["tm"].cfg)
    assert out["engine"].serve(reqs_) == out["results"]


@pytest.mark.parametrize("flags", [["--replicas", "2"], ["--router", "round-robin"],
                                   ["--disaggregate"]])
def test_cli_fleet_flags_raise_naming_a12(flags, capsys):
    """The fleet flags (ROADMAP A12, ported) serve the closed batch through
    ``serve.cluster`` with the single engine's tokens; ``--disaggregate``
    below two replicas is refused as the reference's CLI refuses it (an
    argparse error), and with three (1 prefill + 2 decode) every request
    crosses one handoff."""
    base = CLI + ["--cache-layout", "paged", "--page-size", "8"]
    want = serve_cli.main(base)["results"]
    if flags == ["--disaggregate"]:
        with pytest.raises(SystemExit):
            serve_cli.main(base + flags)
        flags = flags + ["--replicas", "3"]
    out = serve_cli.main(base + flags)
    text = capsys.readouterr().out
    assert out["results"] == want
    if "--router" in flags:          # one replica: the single engine's path
        assert "cluster" not in out
        return
    c = out["cluster"]
    assert c.audit_report.ok and "fleet audit: clean" in text
    assert "cluster: " in text and "router: decisions=" in text
    if "--disaggregate" in flags:
        assert c.last_stats["router"]["handoffs"] == len(want)


def test_cli_backend_flags_map_onto_the_port():
    args = serve_cli.build_parser().parse_args(
        CLI + ["--attn-backend", "jnp", "--verify-backend", "kernel"])
    assert serve_cli._backend(args.attn_backend) == "torch"
    assert serve_cli._backend(args.verify_backend) == "kernel"
    assert serve_cli._backend("auto") is None
