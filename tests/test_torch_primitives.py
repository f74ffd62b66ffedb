"""The port's warp primitives (``repro_torch.core``) against the reference's
(``repro.core``) on the same numpy inputs: every primitive, both backends,
bit for bit; and the port's HW path against its own SW path.  Widths
8/32/64/128, tiles 4/8 and the Table II masks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.primitives as JP  # noqa: E402
import repro_torch.core.primitives as TP  # noqa: E402
from repro.core import TileGroup as JaxTileGroup  # noqa: E402
from repro.core import WarpConfig as JaxWarpConfig  # noqa: E402
from repro.core import group_mask_for as jax_group_mask_for  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MIN_GRANULE,
    TileGroup,
    WarpConfig,
    full_warp_tile,
    group_mask_for,
    size_from_group_mask,
)

WIDTHS = [8, 32, 64, 128]
BACKENDS = ["hw", "sw"]


def _data(shape, dtype, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.uniform(-4, 4, size=shape).astype(dtype)
    return rng.integers(lo, hi, size=shape).astype(dtype)


def _arg(a, to):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a) if to == "jax" else torch.from_numpy(a.copy())
    return a


def _run(name, backend, x, *args, tile=None, **kw):
    """(reference, port) results of primitive ``name`` as numpy arrays."""
    jkw = {k: _arg(v, "jax") for k, v in kw.items()}
    tkw = {k: _arg(v, "torch") for k, v in kw.items()}
    if tile is not None:
        size, ws = tile
        jkw["tile"] = JaxTileGroup(size, JaxWarpConfig(ws))
        tkw["tile"] = TileGroup(size, WarpConfig(ws))
    want = getattr(JP, name)(jnp.asarray(x), *[_arg(a, "jax") for a in args],
                             backend=backend, **jkw)
    got = getattr(TP, name)(torch.from_numpy(x.copy()),
                            *[_arg(a, "torch") for a in args],
                            backend=backend, **tkw)
    return np.asarray(want), got.numpy()


def _same(want, got):
    assert got.shape == want.shape
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# shuffles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", WIDTHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_shfl_modes_match_reference(ws, backend):
    x = _data((3, ws), np.float32, seed=ws)
    for d in (3, ws):                      # ws: every lane keeps its own
        for name in ("shfl_up", "shfl_down"):
            _same(*_run(name, backend, x, d))
    # a power of two takes the pair-swap route, 3 the gather route
    for m in (ws // 2, 3):
        _same(*_run("shfl_xor", backend, x, m))
    _same(*_run("shfl_idx", backend, x, -1))


@pytest.mark.parametrize("ws", WIDTHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_shfl_idx_per_lane_matches_reference(ws, backend):
    x = _data((2, 3, ws), np.int32, seed=1)
    src = _data((2, 3, ws), np.int32, seed=2, lo=-ws, hi=2 * ws)
    _same(*_run("shfl_idx", backend, x, src))
    shared = _data((ws,), np.int32, seed=3, lo=0, hi=ws)   # one index row
    _same(*_run("shfl_idx", backend, x, shared))


# ---------------------------------------------------------------------------
# votes, ballots, match_any
# ---------------------------------------------------------------------------

def _int_mask(ws, seed):
    """An int bitmask with lane 0 left out (the first member is not lane 0)."""
    return int(np.random.default_rng(seed).integers(0, 2 ** min(ws, 62))) & ~1


@pytest.mark.parametrize("ws", WIDTHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_votes_match_reference(ws, backend):
    pred = _data((4, ws), np.int32, seed=5, lo=0, hi=2).astype(bool)
    pred[1] = True
    vals = _data((4, ws), np.int32, seed=6, lo=0, hi=2)
    vals[2] = 7                                              # a uniform row
    # an int bitmask at widths 8 and 64, a lane bool mask at 32 and 128
    mask = (_int_mask(ws, ws) if ws in (8, 64) else
            _data((ws,), np.int32, seed=ws, lo=0, hi=2).astype(bool))
    for name in ("vote_all", "vote_any"):
        _same(*_run(name, backend, pred, member_mask=mask))
    _same(*_run("vote_uni", backend, vals, member_mask=mask))
    want, got = _run("vote_ballot", backend, pred, member_mask=mask)
    _same(want, got)
    assert got.shape == ((4,) if ws <= 32 else (4, ws // 32))


@pytest.mark.parametrize("ws,kind", [(32, "rows"), (64, "words")])
@pytest.mark.parametrize("backend", BACKENDS)
def test_votes_with_per_row_masks_match_reference(ws, kind, backend):
    """A (rows, ws) bool mask (one member set per warp, a row with no
    member) and a (rows,) integer tensor of bitmasks, at the segment
    level where the backends take them."""
    from repro.core import hw_backend as jhw, sw_backend as jsw
    from repro_torch.core import hw_backend as thw, sw_backend as tsw

    jb, tb = (jhw, thw) if backend == "hw" else (jsw, tsw)
    pred = _data((4, ws), np.int32, seed=7, lo=0, hi=2)
    if kind == "rows":
        mask = _data((4, ws), np.int32, seed=8, lo=0, hi=2).astype(bool)
        mask[0] = False
    else:
        mask = _data((4,), np.int64, seed=9, lo=0, hi=2 ** 31)
    for name in ("vote_all", "vote_any", "vote_uni", "vote_ballot"):
        want = getattr(jb, name)(jnp.asarray(pred), ws, jnp.asarray(mask))
        got = getattr(tb, name)(torch.from_numpy(pred), ws, torch.from_numpy(mask))
        _same(np.asarray(want), got.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_word_ballot_at_width_64(backend):
    pred = np.zeros((2, 64), bool)
    pred[0, [0, 31, 32, 63]] = True
    pred[1, 33] = True
    want, got = _run("vote_ballot", backend, pred)
    _same(want, got)
    assert got.dtype == np.uint32
    assert got.tolist() == [[(1 << 31) | 1, (1 << 31) | 1], [0, 2]]


@pytest.mark.parametrize("ws", [8, 32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_match_any_matches_reference(ws, backend):
    v = _data((3, ws), np.int32, seed=7, lo=0, hi=4)
    _same(*_run("match_any", backend, v, member_mask=_int_mask(ws, 8)))
    with pytest.raises(ValueError, match="width <= 32"):
        TP.match_any(torch.zeros(2, 64, dtype=torch.int32), backend=backend)


# ---------------------------------------------------------------------------
# reductions and scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws,op,dtype", [
    (8, "sum", np.float32), (32, "sum", np.float32), (64, "sum", np.float32),
    (128, "sum", np.float32), (32, "max", np.float32), (128, "min", np.float32),
    (64, "prod", np.float32), (8, "sum", np.int32), (128, "prod", np.int32),
    (32, "or", np.int32), (64, "and", np.int32)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_warp_reduce_matches_reference(ws, backend, op, dtype):
    lo, hi = (0, 1 << 20) if op in ("or", "and") else (-9, 10)
    x = _data((3, ws), dtype, seed=ws + 11, lo=lo, hi=hi)
    if op == "prod" and dtype == np.float32:
        x = np.float32(1) + x / np.float32(64)               # keep the product finite
    _same(*_run("warp_reduce", backend, x, op))


@pytest.mark.parametrize("ws,op,dtype", [(8, "sum", np.float32), (32, "max", np.float32),
                                         (128, "sum", np.int32)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_warp_scan_matches_reference(ws, backend, op, dtype):
    x = _data((2, ws), dtype, seed=ws + 12)
    _same(*_run("warp_scan", backend, x, op))


# ---------------------------------------------------------------------------
# tiles (vx_tile) and Table II
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile,ws", [(4, 8), (8, 32), (4, 128)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_segments_match_reference(tile, ws, backend):
    x = _data((2, ws), np.float32, seed=tile + ws)
    for op in ("sum", "max"):
        _same(*_tile_reduce(backend, x, tile, ws, op))
    _same(*_run("shfl_up", backend, x, 1, tile=(tile, ws)))
    _same(*_run("shfl_xor", backend, x, tile // 2, tile=(tile, ws)))
    pred = x > 0
    want, got = _run("vote_ballot", backend, pred, tile=(tile, ws))
    _same(want, got)
    assert got.shape == (2, ws // tile)


def _tile_reduce(backend, x, tile, ws, op):
    want = JP.tile_reduce(jnp.asarray(x), JaxTileGroup(tile, JaxWarpConfig(ws)),
                          op, backend=backend)
    got = TP.tile_reduce(torch.from_numpy(x.copy()), TileGroup(tile, WarpConfig(ws)),
                         op, backend=backend)
    return np.asarray(want), got.numpy()


def test_group_masks_table2():
    """Table II of the paper, verbatim, and the same masks as the reference."""
    assert group_mask_for(32, 32) == 0b10000000
    assert group_mask_for(16, 32) == 0b10001000
    assert group_mask_for(8, 32) == 0b10101010
    assert group_mask_for(4, 32) == 0b11111111
    for ws in (8, 32, 64, 128):
        for size in (4, 8, 16, 32, 64, 128):
            if size > ws:
                continue
            assert group_mask_for(size, ws) == jax_group_mask_for(size, ws)
            assert size_from_group_mask(group_mask_for(size, ws), ws) == size
            assert TileGroup(size, WarpConfig(ws)).group_mask == group_mask_for(size, ws)
    assert MIN_GRANULE == 4
    assert full_warp_tile(WarpConfig(64)).size == 64
    with pytest.raises(ValueError):
        group_mask_for(2, 32)
    with pytest.raises(ValueError):
        size_from_group_mask(0b10011000, 32)                  # non-uniform
    with pytest.raises(ValueError):
        WarpConfig(256)
    with pytest.raises(ValueError):
        TileGroup(16, WarpConfig(8))


# ---------------------------------------------------------------------------
# the port's HW path against its SW path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", WIDTHS)
def test_port_hw_equals_port_sw(ws):
    """Bit for bit wherever the arithmetic is exact (permutes, votes,
    ballots, integer and max/min reductions, tiles); a float sum adds in
    another order on the two paths (butterfly vs serial, as in the
    reference), so it is held to 4 ulps of the reduced magnitude."""
    x = torch.from_numpy(_data((4, ws), np.float32, seed=ws + 20))
    xi = torch.from_numpy(_data((4, ws), np.int32, seed=ws + 21))
    mask = _int_mask(ws, ws + 22)

    def both(name, *args, **kw):
        return (getattr(TP, name)(*args, backend="hw", **kw),
                getattr(TP, name)(*args, backend="sw", **kw))

    pairs = [both("shfl_up", x, 3), both("shfl_down", x, 5),
             both("shfl_xor", x, ws // 2), both("shfl_idx", x, 7),
             both("shfl_idx", x, xi % ws),
             both("vote_all", x > 0, member_mask=mask),
             both("vote_any", x > 0, member_mask=mask),
             both("vote_uni", xi > 0, member_mask=mask),
             both("vote_ballot", x > 0, member_mask=mask),
             both("warp_reduce", x, "max"), both("warp_reduce", x, "min"),
             both("warp_reduce", xi, "sum"), both("warp_scan", xi, "sum"),
             both("tile_reduce", x, TileGroup(4, WarpConfig(ws)), "max")]
    if ws <= 32:
        pairs.append(both("match_any", xi % 3))
    for hw, sw in pairs:
        assert hw.dtype == sw.dtype
        torch.testing.assert_close(hw, sw, atol=0, rtol=0)
    hw, sw = both("warp_reduce", x, "sum")
    torch.testing.assert_close(hw, sw, atol=4 * 2 ** -24 * x.abs().sum(-1).max().item(),
                               rtol=0)


def test_default_backend_dispatch():
    x = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    assert TP.get_default_backend() == "hw"
    try:
        TP.set_default_backend("sw")
        assert TP.get_default_backend() == "sw"
        torch.testing.assert_close(TP.shfl_down(x, 1), TP.shfl_down(x, 1, backend="hw"))
    finally:
        TP.set_default_backend("hw")
    with pytest.raises(ValueError, match="unknown backend"):
        TP.set_default_backend("pallas")
