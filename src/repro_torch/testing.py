"""Weight bridge: the reference ``Model.init`` pytree -> the port's params.

The reference and the port share one parameter layout (nested dicts,
stacked (L, ...) layer leaves, (d_in, d_out) weights), so the bridge is a
leaf-for-leaf copy.  It takes numpy arrays and imports no JAX: a test
converts the reference's arrays with ``numpy.asarray`` first.  The same
bridge carries gradients and AdamW moments (the same leaves) across, and
``to_numpy`` carries the port's trees back for comparison.  Beside it,
helpers that make the tests' inputs: paged decode/verify cases, and int8
pools built from numpy with a byte-for-byte comparison against the
reference's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizer import AdamWState

# the dense family's leaves, as paths into the pytree
DENSE_LEAVES = (
    "embed", "ln_f", "lm_head", "layers.ln1", "layers.ln2",
    "layers.attn.wq", "layers.attn.wk", "layers.attn.wv", "layers.attn.wo",
    "layers.attn.bq", "layers.attn.bk", "layers.attn.bv",
    "layers.mlp.w_gate", "layers.mlp.w_up", "layers.mlp.w_down",
)
_BIASES = ("layers.attn.bq", "layers.attn.bk", "layers.attn.bv")
# the MoE family's layer in place of the dense MLP
MOE_FFN = ("layers.moe.router", "layers.moe.w_gate", "layers.moe.w_up",
           "layers.moe.w_down")


def expected_leaves(cfg) -> tuple:
    """The leaves of a ``cfg`` model's pytree: the dense set, with
    ``layers.moe.*`` in place of ``layers.mlp.*`` for the MoE family, and
    the q/k/v biases only with ``cfg.qkv_bias``."""
    leaves = [p for p in DENSE_LEAVES if cfg.qkv_bias or p not in _BIASES]
    if cfg.family == "moe":
        leaves = [p for p in leaves if not p.startswith("layers.mlp.")] + list(MOE_FFN)
    return tuple(sorted(leaves))


def leaf_paths(tree: Mapping[str, Any], prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out += leaf_paths(v, path + ".") if isinstance(v, Mapping) else [path]
    return sorted(out)


def params_from_numpy(tree: Mapping[str, Any], cfg, *, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Copy every leaf of a numpy pytree into a tensor of ``dtype`` on
    ``device``, keeping the nesting.  Raises unless the tree holds exactly
    the leaves of a ``cfg`` model (:func:`expected_leaves`; a missing or
    extra leaf would otherwise surface later as a KeyError deep inside the
    model)."""
    dev = resolve_device(device)
    paths, want = leaf_paths(tree), list(expected_leaves(cfg))
    if paths != want:
        raise ValueError(f"not a {cfg.family}-family pytree: expected "
                         f"leaves {want}, got {paths}")

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(device=dev, dtype=dtype)

    return conv(tree)


def to_numpy(tree: Mapping[str, Any]) -> dict:
    """A nested dict of tensors (params, grads, moments) as float32 numpy
    arrays, for comparison with the reference's leaves."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def adamw_state_from_numpy(step: int, m: Mapping[str, Any], v: Mapping[str, Any],
                           cfg, *, device: DeviceLike = None):
    """The reference's ``AdamWState`` leaves (as numpy) of a ``cfg`` model
    -> the port's AdamWState (fp32 moments on ``device``)."""
    return AdamWState(step=int(step), m=params_from_numpy(m, cfg, device=device),
                      v=params_from_numpy(v, cfg, device=device))


def paged_decode_case(rng: np.random.Generator, b=2, hkv=2, g=2, d=64, ps=16,
                      n_pages=12, nb=5):
    """Inputs for paged decode tests, as numpy: (q, k_pages, v_pages,
    block_tables, pos).  Pages are mapped in shuffled order, row 0's table
    holds a trash-page entry and a stale mapping past its live prefix, and
    the trash page 0 holds garbage (1e6 keys, NaN values) that a correct
    kernel never reads."""
    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q = rand(b, hkv, g, d)
    kp, vp = rand(n_pages, ps, hkv, d), rand(n_pages, ps, hkv, d)
    kp[0], vp[0] = 1e6, np.nan
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, nb), np.int32)
    bt[0, :3] = perm[:3]                        # row 0 live through block 2
    bt[0, 3:] = [0, perm[3]]                    # trash + a stale mapping
    bt[1, :] = perm[4:4 + nb]
    pos = np.asarray([2 * ps + 5, nb * ps - 1], np.int32)
    return q, kp, vp, bt, pos


def paged_verify_case(rng: np.random.Generator, t=4, b=3, hkv=2, g=2, d=64,
                      ps=16, n_pages=14, nb=5):
    """Inputs for paged verify tests, as numpy: (q (B, Hkv, T*G, D),
    k_pages, v_pages, block_tables, pos).  Pages are mapped in shuffled
    order.  Row 0's window ends inside block 2; the rest of that page, a
    trash entry and a stale mapping past it hold garbage (1e6 keys, NaN
    values), as does the trash page 0.  Row 1's window ends on the last
    table position, and row 2's pos + T runs past the table (a finished
    slot coasting).  A correct kernel reads none of the garbage."""
    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q = rand(b, hkv, t * g, d)
    kp, vp = rand(n_pages, ps, hkv, d), rand(n_pages, ps, hkv, d)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, nb), np.int32)
    bt[0, :3] = perm[:3]                        # row 0 live through block 2
    bt[0, 3:] = [0, perm[3]]                    # trash + a stale mapping
    for r in range(1, b):                       # clean pages, maybe shared
        bt[r, :] = rng.permutation(perm[4:])[:nb]
    pos = np.asarray([2 * ps + 3, nb * ps - t, nb * ps - 1][:b], np.int32)
    last0 = int(pos[0]) + t - 1
    for page, rows in ((0, slice(None)), (bt[0, 2], slice(last0 % ps + 1, None)),
                       (bt[0, 4], slice(None))):
        kp[page, rows], vp[page, rows] = 1e6, np.nan
    return q, kp, vp, bt, pos


# verify windows across the split kernel's edges: 10 pages of 16 keys.
# With 3 splits a window of n <= 96 live keys takes 32-key splits, of
# 97..160 64-key splits (and the wrappers' own count gives one-tile splits
# at B 5).  pos 14 straddles a page edge, pos 30 a split edge (T 4: keys
# 30..33, so the split of keys 32 and 33 lies wholly past rows t = 0 and
# 1), pos 61 puts a row limit inside a split and crosses both edges at T 4
# and T 8, and the last slot's window runs past the table's end for T > 3
# (a finished slot coasting: n clamps to the table).
VERIFY_SPLIT_POS = (0, 14, 30, 61, 157)
VERIFY_SPLIT_PAGE, VERIFY_SPLIT_NB = 16, 10


def verify_split_case(rng: np.random.Generator, t: int, hkv: int, g: int, d: int):
    """Inputs for the split verify tests, as numpy: (q (B, Hkv, T*G, D),
    k_pages, v_pages, block_tables, pos) at VERIFY_SPLIT_POS, in shuffled
    pages behind a NaN trash page 0.  Rows past each window's last
    position hold NaN, and table columns past its last page point at the
    trash page."""
    ps, nb = VERIFY_SPLIT_PAGE, VERIFY_SPLIT_NB
    b, s_len = len(VERIFY_SPLIT_POS), ps * nb
    q = rng.standard_normal((b, hkv, t * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    for i, p in enumerate(VERIFY_SPLIT_POS):
        k[i, p + t:], v[i, p + t:] = np.nan, np.nan
    kp = np.full((b * nb + 1, ps, hkv, d), np.nan, np.float32)
    vp = kp.copy()
    bt = (rng.permutation(b * nb) + 1).reshape(b, nb).astype(np.int32)
    for i, p in enumerate(VERIFY_SPLIT_POS):
        for j in range(nb):
            kp[bt[i, j]], vp[bt[i, j]] = k[i, j * ps:(j + 1) * ps], v[i, j * ps:(j + 1) * ps]
        bt[i, (p + t - 1) // ps + 1:] = 0
    return q, kp, vp, bt, np.asarray(VERIFY_SPLIT_POS, np.int32)


def quantized_pool_from_numpy(kv: np.ndarray, *, device: DeviceLike = None) -> dict:
    """A float K/V pair ``kv`` (2, L, P, page_size, Hkv, D), as numpy,
    quantized into an int8 pool {"k_pages", "v_pages", "k_scales",
    "v_scales"} on ``device`` by the port's ``quantize_kv_rows``."""
    from repro_torch.serve.kv_cache import quantize_kv_rows

    dev = resolve_device(device)
    pool = {}
    for i, name in enumerate("kv"):
        q, s = quantize_kv_rows(torch.from_numpy(np.asarray(kv[i], np.float32)))
        pool[f"{name}_pages"], pool[f"{name}_scales"] = q.to(dev), s.to(dev)
    return pool


def pool_mismatches(pool: Mapping[str, torch.Tensor],
                    ref: Mapping[str, Any]) -> list:
    """Leaves of a port pool whose bytes differ from the reference pool's
    (given as numpy arrays): another leaf set, dtype or shape, or any
    differing element.  Floats are compared by their bit patterns, so a
    NaN equals the same NaN and -0.0 differs from 0.0.  [] when the two
    pools hold the same bytes."""
    if set(pool) != set(ref):
        return sorted(set(pool) ^ set(ref))
    bad = []
    for name, t in pool.items():
        got = t.detach().cpu().numpy()
        want = np.asarray(ref[name])
        if got.dtype != want.dtype or got.shape != want.shape:
            bad.append(name)
            continue
        if got.dtype.kind == "f":
            got, want = got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}")
        if not np.array_equal(got, want):
            bad.append(name)
    return bad
