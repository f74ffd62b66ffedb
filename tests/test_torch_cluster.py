"""The fleet (ROADMAP A12: ``repro_torch.serve.cluster`` and the engine's
handoff hooks) on the CPU.

The counterpart of the reference's ``tests/test_cluster.py`` and
``tests/test_pipeline_overlap.py::test_pipeline_parity_cluster_disaggregated``.
A request's tokens must not depend on where it runs, so each parity case
holds the port's fleet to the port's direct engine (which the port's
engine tests hold to the reference's): replicas 1 / 2 / 4 by router
policy, disaggregated prefill and decode greedy and at T 0.8, per-worker
fault schedules, a worker killed mid-serve, the async front end, and
pipelined workers against a serial engine.  Once the port's fleet is held
to the reference's fleet directly (the disaggregated case's tokens, on the
same weights).  The router's choices and ``route_handoff``'s are held to
the reference's on the same ``WorkerStats`` sequences (pure Python).  A
``SwapHandle`` migrated out of one engine's session restores into
another's of another pool size.  And one engine holds one session at a
time: a second ``_open_session`` raises until the first is finalized or
aborted.  Reduced qwen2-1.5b in fp32, the reference test's engine
settings (max_seq 48, 2 slots, 8-token pages)."""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.lm import Model as JaxModel  # noqa: E402
from repro.serve.cluster import Router as JaxRouter  # noqa: E402
from repro.serve.cluster import make_cluster as jax_make_cluster  # noqa: E402
from repro.serve.cluster import route_handoff as jax_route_handoff  # noqa: E402
from repro.serve.cluster.worker import WorkerStats as JaxWorkerStats  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.lm import Model  # noqa: E402
from repro_torch.serve.audit import audit_fleet  # noqa: E402
from repro_torch.serve.cluster import (  # noqa: E402
    AsyncClusterFrontend,
    ClusterController,
    EngineWorker,
    Router,
    WorkerDead,
    WorkerStats,
    make_cluster,
    route_handoff,
)
from repro_torch.serve.engine import (  # noqa: E402
    STATUS_FAILED,
    STATUS_OK,
    Request,
    ServeEngine,
)
from repro_torch.serve.sla import merge_ledgers  # noqa: E402
from repro_torch.testing import params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The engines run many small torch ops a step; one intra-op thread
    keeps them fast on a loaded CPU (as ``test_torch_sampling.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2-1.5b"
EKW = dict(max_seq=48, batch_slots=2, temperature=0.0, seed=0, cache_layout="paged",
           page_size=8)
_CACHE = {}


def _models():
    """(JAX model, JAX params, port model, port params): the reference
    test's weights (PRNGKey(1)), carried over."""
    if not _CACHE:
        jm = JaxModel(jax_reduced_config(ARCH), compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = Model(reduced_config(ARCH), device="cpu", dtype=torch.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH),
                               device="cpu")
        _CACHE.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _CACHE["jm"], _CACHE["jp"], _CACHE["tm"], _CACHE["tp"]


def _engine(**kw):
    _, _, tm, tp = _models()
    return ServeEngine(tm, tp, **{**EKW, **kw})


def _cluster(**kw):
    _, _, tm, tp = _models()
    return make_cluster(tm, tp, **{**EKW, **kw})


def _reqs(n, seed=3, plo=3, phi=12, mlo=2, mhi=7):
    """The reference test's requests."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 512, size=int(rng.integers(plo, phi))).tolist(),
                    max_new_tokens=int(rng.integers(mlo, mhi))) for i in range(n)]


def _fresh(reqs):
    return [dataclasses.replace(r, generated=None) for r in reqs]


def _direct(reqs, **kw):
    """The port's direct engine, once per (requests, settings)."""
    key = ("direct", tuple(tuple(r.prompt) for r in reqs), tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = _engine(**kw).serve(_fresh(reqs))
    return _CACHE[key]


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("replicas,policy", [(1, "round-robin"), (2, "cache-aware"),
                                             (4, "least-loaded")])
def test_cluster_parity_with_direct_engine(replicas, policy):
    """{uid: tokens} from a fleet equals one direct engine's, for each
    replica count and router policy; one terminal status a request."""
    reqs = _reqs(8)
    c = _cluster(replicas=replicas, router_policy=policy)
    assert c.serve(_fresh(reqs)) == _direct(reqs)
    assert c.audit_report.ok
    assert {e["status"] for e in c.fleet.values()} == {STATUS_OK}
    assert sum(c.last_stats["router"]["decisions"].values()) == len(reqs)
    assert len({id(w.engine) for w in c.workers.values()}) == replicas


def test_disaggregated_handoff_parity():
    """The prefill replica samples the first token, the pages leave as a
    SwapHandle and a decode replica restores them: the direct engine's
    tokens, one handoff a request, and a restore (not a prefill) on the
    decode side."""
    reqs = _reqs(6)
    c = _cluster(replicas=3, disaggregate=True, router_policy="least-loaded")
    assert c.serve(_fresh(reqs)) == _direct(reqs)
    assert c.audit_report.ok
    assert all(e["handoffs"] == 1 for e in c.fleet.values())
    assert c.last_stats["router"]["handoffs"] == len(reqs)
    ledgers = merge_ledgers([dict(w.ledger) for w in c.workers.values()])
    assert all(ledgers[r.uid].get("swap_ins", 0) >= 1 for r in reqs)
    assert all(ledgers[r.uid]["handoffs"] == 1 for r in reqs)
    # the prefill worker's session never decodes: its slots leave at once
    assert c.last_pool_stats[0].swap_outs == len(reqs)


def test_disaggregated_parity_matches_reference_fleet():
    """The one direct hold on the reference's fleet: the same weights and
    requests through the reference's disaggregated fleet and the port's
    give the same tokens and the same placements and handoffs."""
    jm, jp, _, _ = _models()
    reqs = _reqs(6)
    jc = jax_make_cluster(jm, jp, replicas=3, disaggregate=True,
                          router_policy="least-loaded", **EKW)
    want = jc.serve([JaxRequest(r.uid, list(r.prompt), r.max_new_tokens) for r in reqs])
    c = _cluster(replicas=3, disaggregate=True, router_policy="least-loaded")
    assert c.serve(_fresh(reqs)) == want
    assert {u: e["worker"] for u, e in c.fleet.items()} == {
        u: e["worker"] for u, e in jc.fleet.items()}
    for k in ("handoffs", "reroutes", "rounds", "decisions"):
        assert c.last_stats["router"][k] == jc.last_stats["router"][k], k


def test_disaggregated_parity_with_temperature():
    """Sampling stays keyed by (uid, position) across the handoff."""
    reqs = _reqs(5, seed=11)
    c = _cluster(replicas=2, disaggregate=True, temperature=0.8)
    assert c.serve(_fresh(reqs)) == _direct(reqs, temperature=0.8)


def test_pipeline_parity_cluster_disaggregated():
    """A 2-replica disaggregated fleet of pipelined workers serves the
    serial direct engine's tokens (``test_pipeline_overlap.py:166``)."""
    reqs = _reqs(6)
    want = _engine(pipeline=False).serve(_fresh(reqs))
    c = _cluster(replicas=2, disaggregate=True, pipeline=True)
    assert all(w.engine.pipeline for w in c.workers.values())
    assert c.serve(_fresh(reqs)) == want
    assert c.audit_report.ok


def test_worker_death_drains_through_retry():
    """A replica killed mid-serve loses its requests to the retry path:
    the survivors serve them with the direct engine's tokens, the fleet
    (the dead pool included) audits clean, and the dead replica's ledger
    shows them failed."""
    reqs = _reqs(8)
    c = _cluster(replicas=3, router_policy="round-robin")
    for r in _fresh(reqs):
        c.submit(r)
    c.step()
    c.step()
    c.fail_worker(1)
    assert not c.workers[1].alive
    c.drain()
    assert c.close() == _direct(reqs)
    assert c.audit_report.ok
    assert c.last_stats["router"]["reroutes"] >= 1
    rerouted = [u for u, e in c.fleet.items() if e["reroutes"]]
    assert rerouted and all(c.fleet[u]["worker"] != 1 for u in rerouted)
    dead = {u: s["status"] for u, s in c.workers[1].ledger.items() if isinstance(u, int)}
    assert STATUS_FAILED in dead.values()
    # the dead worker's engine closed its session: it could open another
    c.workers[1].engine._abort(c.workers[1].engine._open_session([]),
                               RuntimeError("probe"))


def test_cluster_parity_under_per_worker_faults():
    """Each replica runs its own schedule from ``random_for_worker``; the
    requests that end ok carry the fault-free direct engine's tokens."""
    reqs = _reqs(6)
    c = _cluster(replicas=2, faults_seed=13)
    out = c.serve(_fresh(reqs))
    ok = {u for u, e in c.fleet.items() if e["status"] == STATUS_OK}
    assert ok and set(out) == ok
    want = _direct(reqs)
    assert all(out[u] == want[u] for u in ok)
    assert c.audit_report.ok


def test_async_cluster_frontend_streams_match_batch():
    """The streaming front end: each stream yields the direct engine's
    tokens, and ``close()`` returns them."""
    reqs = _reqs(7)

    async def run():
        c = _cluster(replicas=2, router_policy="cache-aware")
        async with AsyncClusterFrontend(c, backpressure_watermark=4) as fe:
            streams = [await fe.submit(r) for r in _fresh(reqs)]
            outs = {}
            for s in streams:
                toks = [t async for t in s]
                if s.status == STATUS_OK:
                    outs[s.uid] = toks
            res = await fe.close()
        return outs, res, c

    outs, res, c = asyncio.run(run())
    assert outs == res == _direct(reqs)
    assert c.audit_report.ok


# ------------------------------------------------------------ the messages
def test_dead_worker_rejects_messages():
    c = _cluster(replicas=2)
    c.workers[0].fail()
    with pytest.raises(WorkerDead):
        c.workers[0].submit(_reqs(1)[0])
    with pytest.raises(WorkerDead):
        c.workers[0].step()


def test_decode_role_rejects_raw_prompts():
    c = _cluster(replicas=2, disaggregate=True)
    with pytest.raises(ValueError, match="decode-role"):
        c.workers[1].submit(_reqs(1)[0])


def test_mismatched_replicas_rejected():
    """A fleet whose replicas would sample differently fails at
    construction."""
    w0 = EngineWorker(0, _engine())
    w1 = EngineWorker(1, _engine(temperature=0.5))
    with pytest.raises(ValueError, match="replicas disagree"):
        ClusterController([w0, w1], Router([0, 1]))


def test_duplicate_uid_rejected():
    c = _cluster(replicas=2)
    r = _reqs(1)[0]
    c.submit(r)
    with pytest.raises(ValueError, match="duplicate"):
        c.submit(dataclasses.replace(r, generated=None))


def test_make_cluster_validation():
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="replica"):
        make_cluster(tm, tp, replicas=0, **EKW)
    with pytest.raises(ValueError, match="disaggregation"):
        make_cluster(tm, tp, replicas=1, disaggregate=True, **EKW)
    with pytest.raises(ValueError, match="prefill_workers"):
        make_cluster(tm, tp, replicas=2, disaggregate=True, prefill_workers=2, **EKW)
    with pytest.raises(ValueError, match="paged"):
        EngineWorker(0, ServeEngine(tm, tp, max_seq=48, batch_slots=2))


def test_one_engine_holds_one_session():
    """The port's engine keeps one session's device state: a second
    ``_open_session`` raises while one is open, a finalize or an abort
    closes it (a failed session never blocks the next), and serve()
    leaves none open."""
    eng = _engine()
    st = eng._open_session([])
    with pytest.raises(RuntimeError, match="already has an open session"):
        eng._open_session([])
    with pytest.raises(RuntimeError, match="already has an open session"):
        EngineWorker(0, eng)
    eng._finalize_session(st)
    st = eng._open_session(_fresh(_reqs(2)))
    with pytest.raises(RuntimeError, match="without a terminal status"):
        eng._finalize_session(st)
    st = eng._open_session([])
    eng._abort(st, RuntimeError("test"))
    reqs = _reqs(3)
    assert eng.serve(_fresh(reqs)) == _direct(reqs)
    assert eng._session is None
    # make_cluster gives each worker its own engine over the same tensors
    c = _cluster(replicas=2)
    e0, e1 = (c.workers[i].engine for i in (0, 1))
    assert e0 is not e1 and e0.params is e1.params and e0.model is e1.model


# ------------------------------------------------- cross-session handoff
def _drive_to_live(eng, st, uid):
    for _ in range(50):
        eng._round(st)
        if any(r.uid == uid for r in st.live.values()):
            return
    raise AssertionError("request never became live")


def test_swap_handle_restores_across_managers():
    """A handle migrated out of one engine's session restores into another
    engine's session of another pool size whose allocator hands out other
    page ids: the direct engine's tokens, and both pools audit clean."""
    reqs = _reqs(4, seed=7, plo=10, phi=14, mlo=4, mhi=6)
    src = _engine(num_pages=32)
    st_a = src._open_session([], None)
    for r in _fresh(reqs):
        src._submit_open(st_a, r)
    _drive_to_live(src, st_a, reqs[0].uid)
    resume, handle, carry = src._migrate_out(st_a, reqs[0].uid)
    assert handle.page_size == src.page_size and handle.n_tokens == len(reqs[0].prompt) + len(
        resume.generated) - 1
    assert reqs[0].uid not in st_a.stats and resume.folded == len(resume.generated)
    dst = _engine(num_pages=20)
    st_b = dst._open_session([], None)
    dst._submit_open(st_b, Request(uid=900, prompt=list(range(17)), max_new_tokens=2))
    dst._submit_resume(st_b, resume, handle=handle, carry=carry)
    assert st_b.stats[reqs[0].uid]["handoffs"] == 1
    while st_b.queue or st_b.live or st_b.prefilling:
        dst._round(st_b)
    out = dst._finalize_session(st_b)
    assert out[reqs[0].uid] == _direct(reqs)[reqs[0].uid]
    assert dst.last_stats[reqs[0].uid]["swap_ins"] == 1
    src._abort(st_a, RuntimeError("test teardown"))
    assert audit_fleet({"a": st_a.mgr, "b": st_b.mgr}).ok


def test_resume_that_never_fits_fails_alone():
    """A handed-over request whose true remaining footprint exceeds the
    destination pool ends failed (``never-fits: resume needs ...``); the
    session serves on."""
    eng = _engine(num_pages=3)
    st = eng._open_session([])
    big = Request(uid=5, prompt=list(range(30)), max_new_tokens=10, folded=0)
    eng._submit_resume(st, big, carry={"preemptions": 2})
    assert st.stats[5]["status"] == STATUS_FAILED
    assert st.stats[5]["reason"].startswith("never-fits: resume needs")
    assert st.stats[5]["preemptions"] == 2 and st.stats[5]["handoffs"] == 1
    eng._finalize_session(st)


# --------------------------------------------------------------- routing
def _stats_pair(wid, q=0, live=0, pf=0, free=16, role="mixed", alive=True):
    kw = dict(worker_id=wid, role=role, alive=alive, queue_depth=q, live_slots=live,
              prefilling=pf, free_pages=free, total_pages=16, rounds=0)
    return WorkerStats(**kw), JaxWorkerStats(**kw)


@pytest.mark.parametrize("policy", ["round-robin", "least-loaded", "cache-aware"])
def test_router_choices_match_reference(policy):
    """Both routers over one random sequence of load snapshots, prompts
    drawn from shared prefixes (so affinity matters), eligibility
    subsets and catalog advertisements: every pick, the decision counts
    and the affinity hits are the reference's."""
    rng = np.random.default_rng(17)
    ids = [0, 1, 2, 3]
    port, ref = (R(ids, policy=policy, page_size=8) for R in (Router, JaxRouter))
    heads = [rng.integers(0, 512, 24).tolist() for _ in range(3)]
    for step in range(60):
        pairs = {w: _stats_pair(w, q=int(rng.integers(0, 5)), live=int(rng.integers(0, 3)),
                                pf=int(rng.integers(0, 2)), free=int(rng.integers(0, 17)),
                                alive=bool(rng.random() > 0.1)) for w in ids}
        if not any(p[0].alive for p in pairs.values()):
            continue
        prompt = heads[int(rng.integers(0, 3))][:int(rng.integers(8, 25))] + \
            rng.integers(0, 512, int(rng.integers(0, 9))).tolist()
        eligible = None if rng.random() < 0.7 else sorted(
            rng.choice(ids, size=int(rng.integers(1, 4)), replace=False).tolist())
        if eligible is not None and not any(pairs[w][0].alive for w in eligible):
            continue
        if step % 9 == 8:
            w = int(rng.integers(0, 4))
            keys = port._catalog[w] if rng.random() < 0.5 else set()
            port.advertise(w, keys)
            ref.advertise(w, set(keys))
        got = port.route(Request(step, prompt, 4), {w: p[0] for w, p in pairs.items()},
                         eligible=eligible)
        want = ref.route(JaxRequest(step, prompt, 4), {w: p[1] for w, p in pairs.items()},
                         eligible=eligible)
        assert got == want, step
    assert port.decisions == ref.decisions
    assert port.affinity_hits == ref.affinity_hits
    if policy == "cache-aware":
        assert port.affinity_hits > 0


def test_route_handoff_matches_reference():
    """Handoff placement (least loaded among decode-capable replicas) on
    random snapshots, and the refusal when none is alive."""
    rng = np.random.default_rng(5)
    roles = ["prefill", "decode", "mixed", "decode"]
    for _ in range(40):
        pairs = {w: _stats_pair(w, q=int(rng.integers(0, 4)), live=int(rng.integers(0, 3)),
                                free=int(rng.integers(0, 17)), role=roles[w],
                                alive=bool(rng.random() > 0.2)) for w in range(4)}
        port = {w: p[0] for w, p in pairs.items()}
        ref = {w: p[1] for w, p in pairs.items()}
        if not any(s.alive and s.role != "prefill" for s in port.values()):
            with pytest.raises(RuntimeError, match="decode-capable"):
                route_handoff(list(range(4)), port)
            continue
        assert route_handoff(list(range(4)), port) == jax_route_handoff(list(range(4)), ref)
    with pytest.raises(RuntimeError, match="decode-capable"):
        route_handoff([0], {0: _stats_pair(0, role="prefill")[0]})


def test_cache_aware_affinity_beats_moderate_load():
    """The reference test's case: a replica holding the prompt's prefix
    wins with a deeper queue until the load gap passes the bonus."""
    from repro_torch.serve.prefix_index import page_prefix_keys

    r = Router([0, 1], policy="cache-aware", page_size=8, affinity_weight=4,
               load_weight=1)
    req = Request(uid=5, prompt=list(range(16)), max_new_tokens=4)
    r.advertise(0, set(page_prefix_keys(req.prompt, 8)))
    assert r.route(req, {0: _stats_pair(0, q=3)[0], 1: _stats_pair(1)[0]}) == 0
    assert r.affinity_hits == 1
    assert r.route(req, {0: _stats_pair(0, q=9)[0], 1: _stats_pair(1)[0]}) == 1
    with pytest.raises(ValueError, match="policy"):
        Router([0], policy="random")
