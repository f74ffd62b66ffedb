"""The rank closed form of MoE top-k gating against the Pallas kernel's k
rounds: ``moe_gating_rank_ref`` (what the CUDA kernel computes) equals
``moe_gating_ref`` (the rounds, step by step) bit for bit, masks and
weights, on the MoE tests' gating cases and on seeded adversarial rows
drawn from the sentinel pool (-1e30, -inf, -3e38, +inf, +0/-0, ties,
NaN), E in {16, 32, 64, 128}, k from 1 to min(E, 10) and k = E, f32 and
bf16; both against the reference's Pallas kernel in interpret mode on a
few of those; and the closed form's branches pinned by name on
hand-written rows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gating.ops import moe_gating_op  # noqa: E402
from repro_torch.kernels.moe_gating.ref import (  # noqa: E402
    moe_gating_rank_ref,
    moe_gating_ref,
)
from test_torch_moe import GATING_CASES, _gating_case  # noqa: E402

# gating weights are softmax values <= 1 from the same f32 exps, summed in
# another order by XLA: a few f32 ulps (test_torch_moe.py's GATE_TOL)
GATE_TOL = dict(atol=1e-6, rtol=0)
NEG = -1e30
POOL = np.array([NEG, -np.inf, -3e38, np.inf, 0.0, -0.0, 1.0, -1.0], np.float32)
ADVERSARIAL = [(e, k) for e in (16, 32, 64, 128)
               for k in sorted(set(range(1, min(e, 10) + 1)) | {e})]


def adversarial_rows(e: int, seed: int, t: int = 48) -> np.ndarray:
    """(t, E) f32: N(0, 4) rows with 0, 10, 50, 90 and 100 % of their
    lanes drawn from POOL (so many rows hold fewer than k values above
    -1e30, and ties), rows of the sentinel edges, and two NaN rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, e)) * 2).astype(np.float32)
    for r in range(t):
        hit = rng.random(e) < (0.0, 0.1, 0.5, 0.9, 1.0)[r % 5]
        x[r, hit] = rng.choice(POOL, hit.sum())
    x[0] = NEG                                       # nothing above: expert 0
    x[1] = -np.inf                                   # -1e30 below the one value
    x[1, [2, 5, 7]] = (NEG, 3.0, NEG)
    x[2] = -np.inf                                   # -1e30 only above it
    x[2, [2, 5]] = (3.0, NEG)
    x[3, rng.integers(e)] = np.nan
    x[4] = np.nan
    return x


def _bits(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.int32)


def assert_same(got, want):
    """Masks equal and weights equal bit for bit (NaN payloads too)."""
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))


def assert_pallas(x: np.ndarray, bf16: bool, k: int, got):
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    w_want, m_want = (np.asarray(a) for a in moe_gating_op(jx, k, interpret=True))
    np.testing.assert_array_equal(got[1].numpy(), m_want)
    np.testing.assert_allclose(got[0].numpy(), w_want, **GATE_TOL)


def _tensor(x: np.ndarray, bf16: bool) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("case", GATING_CASES)
def test_rank_equals_rounds_on_gating_cases(case):
    x, bf16, k = _gating_case(case)
    tx = _tensor(x, bf16)
    assert_same(moe_gating_rank_ref(tx, k), moe_gating_ref(tx, k))


@pytest.mark.parametrize("e,k", ADVERSARIAL, ids=[f"E{e}-k{k}" for e, k in ADVERSARIAL])
def test_rank_equals_rounds_on_adversarial_rows(e, k):
    x = adversarial_rows(e, seed=1000 * e + k)
    for bf16 in (False, True):
        tx = _tensor(x, bf16)
        got, want = moe_gating_rank_ref(tx, k), moe_gating_ref(tx, k)
        assert_same(got, want)
        nan_rows = np.isnan(x).any(-1)
        assert (got[1].sum(-1).numpy()[nan_rows] == 0).all()
        assert (got[1].sum(-1).numpy()[~nan_rows] >= 1).all()


@pytest.mark.parametrize("e,k,bf16", [(16, 5, False), (32, 32, False), (64, 8, True),
                                      (128, 10, False)])
def test_both_plain_versions_match_the_pallas_kernel(e, k, bf16):
    """Interpret mode; each shape and k costs the Pallas kernel a trace of
    its own, so only these four."""
    x = adversarial_rows(e, seed=1000 * e + k)
    tx = _tensor(x, bf16)
    for fn in (moe_gating_ref, moe_gating_rank_ref):
        assert_pallas(x, bf16, k, fn(tx, k))


# (row, k, the selected ids, finite weights) for each branch of the closed
# form, E = 16; a row whose picks all lie below -1e30 gets 0 / 0 = NaN
# weights, as the Pallas kernel's softmax over -1e30 masks gives them
_I = float("inf")
BRANCHES = {
    # a NaN anywhere: nothing, NaN weights
    "nan_row": ([1.0, float("nan")] + [0.0] * 14, 4, [], False),
    # n >= k: rank < k; +0 and -0 tie, the lower id first
    "n_at_least_k": ([0.0, -0.0, 2.0, -0.0, 5.0] + [-1.0] * 11, 4, [0, 1, 2, 4], True),
    # 1 <= n < k: the values above -1e30, then the lowest -1e30 id if it is
    # below them all (3 here; 14, above them, never)
    "n_below_k": ([-_I, -_I, -_I, NEG, 0.5, -3e38, 2.0] + [-_I] * 7 + [NEG, -_I], 4,
                  [3, 4, 6], True),
    # ...and not when the lowest -1e30 id lies above a selected one
    "n_below_k_sentinel_above": ([-_I, 0.5, -_I, NEG] + [-_I] * 12, 4, [1], True),
    # n = 0: one expert, the lowest id of the max (-3e38 beats -inf)
    "n_zero": ([-_I, -_I, -3e38, -_I, -3e38] + [-_I] * 11, 4, [2], False),
    "n_zero_all_neg_inf": ([-_I] * 16, 8, [0], False),
    "n_zero_all_sentinel": ([NEG] * 16, 8, [0], True),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_closed_form_branches(branch):
    row, k, ids, finite = BRANCHES[branch]
    x = torch.tensor([row], dtype=torch.float32)
    w, m = moe_gating_rank_ref(x, k)
    assert m[0].nonzero().flatten().tolist() == ids
    assert_same((w, m), moe_gating_ref(x, k))
    if finite:
        assert torch.isfinite(w).all() and w[0, ids].sum().item() == pytest.approx(1.0)
    else:
        assert torch.isnan(w).all()
