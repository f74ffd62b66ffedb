"""Attention-free token mixers: RWKV6 (Finch) and Mamba2 (SSD).

Counterpart of ``repro.models.recurrent``, in the same parameter layout
(``(d_in, d_out)`` weights applied as ``x @ W``) and with the same
states: RWKV6's token shift (B, d) and its fp32 ``wkv`` matrix (B, H, hs,
hs), Mamba2's conv tail (B, K - 1, d_in + 2n) and its fp32 SSD state (B,
nh, hd, n).  Each mixer takes the state it continues from (None: zeros)
and returns the new one; the model writes it into its cache in place.

The recurrences run no kernel, as the reference's ``lax.scan`` runs no
Pallas kernel: each is a loop over time in plain PyTorch, in the
reference's order of operations, with the decays in fp32.  What does
not depend on the carried state (the projections, RWKV6's k v^T outer
products and their bonus-weighted copies, Mamba2's dt x B^T updates) is
computed for all time steps before the loop, elementwise as the
reference's step computes it.  The inner norms (RWKV6's ``ln_x``,
Mamba2's ``norm_w``) use the reference's ``rmsnorm(x, w)`` defaults,
eps 1e-6 and the default reduction form whatever the model's
``WarpFeatureConfig``; with ``use_kernel`` they reach the rmsnorm kernel
on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm

INNER_NORM_EPS = 1e-6   # the reference's rmsnorm default, not cfg.norm_eps
RWKV_LORA = 64          # rank of RWKV6's data-dependent decay


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay time mix + channel mix
# ---------------------------------------------------------------------------

def init_rwkv6_params(gen: torch.Generator, cfg, *, device, dtype) -> dict:
    """One layer's time- and channel-mix weights with the reference's
    distributions, drawn from ``gen`` in the reference's leaf order (the
    channel mix's ``cv`` and ``cr`` last, as its ``fold_in`` keys are)."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    kw = dict(device=device, dtype=dtype)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return {
        # token-shift mix coefficients (per channel, per projection)
        "mu": (uniform(5, d) * 0.5 + 0.25).to(dtype),
        "wr": dense_init(gen, d, d, **kw),
        "wk": dense_init(gen, d, d, **kw),
        "wv": dense_init(gen, d, d, **kw),
        "wg": dense_init(gen, d, d, **kw),
        "wo": dense_init(gen, d, d, **kw),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": (normal(d) * 0.1 - 6.0).to(dtype),
        "wA": dense_init(gen, d, RWKV_LORA, **kw),
        "wB": dense_init(gen, RWKV_LORA, d, **kw),
        "bonus": (normal(d // hs, hs) * 0.1).to(dtype),
        "ln_x": torch.ones(d, **kw),
        # channel mix
        "mu_c": (uniform(2, d) * 0.5 + 0.25).to(dtype),
        "ck": dense_init(gen, d, cfg.d_ff, **kw),
        "cv": dense_init(gen, cfg.d_ff, d, **kw),
        "cr": dense_init(gen, d, d, **kw),
    }


def _shifted(x: torch.Tensor, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, d) shifted one step along time, ``shift`` (B, d) (None:
    zeros) in front."""
    if shift is None:
        shift = torch.zeros_like(x[:, 0])
    return torch.cat([shift[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv6_projections(p, x: torch.Tensor, x_prev: torch.Tensor):
    """x, x_prev (B, S, d) -> r, k, v, g (x's dtype) and the decay w in
    fp32, each (B, S, d)."""
    dt = x.dtype
    mu = p["mu"].to(dt)
    xs = [x + (x_prev - x) * mu[i] for i in range(5)]   # r, k, v, g, w mixes
    r = xs[0] @ p["wr"].to(dt)
    k = xs[1] @ p["wk"].to(dt)
    v = xs[2] @ p["wv"].to(dt)
    g = xs[3] @ p["wg"].to(dt)
    dd = torch.tanh(xs[4] @ p["wA"].to(dt))
    w = p["w0"].to(dt) + dd @ p["wB"].to(dt)
    return r, k, v, g, torch.exp(-torch.exp(w.float()))   # decay in (0, 1)


def rwkv6_time_mix(p, x: torch.Tensor, cfg,
                   state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, *,
                   use_kernel: bool = True):
    """x (B, S, d); state (shift (B, d), wkv (B, H, hs, hs) fp32) or None.
    Returns (out (B, S, d), (new shift, new wkv))."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    shift, wkv = (None, None) if state is None else state
    if wkv is None:
        wkv = torch.zeros(b, h, hs, hs, dtype=torch.float32, device=x.device)
    r, k, v, g, w = _rwkv6_projections(p, x, _shifted(x, shift))
    rh = r.reshape(b, s, h, hs).float()
    kh = k.reshape(b, s, h, hs).float()
    vh = v.reshape(b, s, h, hs).float()
    wh = w.reshape(b, s, h, hs)
    u = p["bonus"].float()
    kv = kh[..., :, None] * vh[..., None, :]              # (B, S, H, hs, hs)
    ukv = u[..., :, None] * kv
    S = wkv.float()                                       # k-major state
    outs = []
    for t in range(s):
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], S + ukv[:, t]))
        S = wh[:, t, :, :, None] * S + kv[:, t]
    out = torch.stack(outs, dim=1).reshape(b, s, d)
    out = rmsnorm(out.to(x.dtype), p["ln_x"], INNER_NORM_EPS, use_kernel)
    out = out * F.silu(g)
    return out @ p["wo"].to(x.dtype), (x[:, -1], S)


def rwkv6_channel_mix(p, x: torch.Tensor, cfg, shift: Optional[torch.Tensor] = None):
    """x (B, S, d); shift (B, d) or None.  Returns (out (B, S, d), new
    shift (B, d))."""
    dt = x.dtype
    x_prev = _shifted(x, shift)
    mu = p["mu_c"].to(dt)
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    kk = torch.square(torch.relu(xk @ p["ck"].to(dt)))
    vv = kk @ p["cv"].to(dt)
    rr = torch.sigmoid(xr @ p["cr"].to(dt))
    return rr * vv, x[:, -1]


# ---------------------------------------------------------------------------
# Mamba2 (SSD): Zamba2's backbone mixer
# ---------------------------------------------------------------------------

def init_mamba2_params(gen: torch.Generator, cfg, *, device, dtype) -> dict:
    """One Mamba2 layer's weights with the reference's distributions."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    kw = dict(device=device, dtype=dtype)
    in_proj = dense_init(gen, d, 2 * d_in + 2 * n + nh, **kw)
    conv_w = (torch.randn(cfg.ssm_conv, d_in + 2 * n, generator=gen, device=device)
              * 0.2).to(dtype)
    dt_bias = (torch.rand(nh, generator=gen, device=device) * 2 - 4).to(dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(d_in + 2 * n, **kw),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)).to(dtype),
        "D": torch.ones(nh, **kw),
        "dt_bias": dt_bias,
        "norm_w": torch.ones(d_in, **kw),
        "out_proj": dense_init(gen, d_in, d, **kw),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d and SiLU: x (B, S, C), w (K, C), b (C,);
    conv_state (B, K - 1, C) the trailing context of earlier steps (None:
    zeros).  Returns (out (B, S, C), new state (B, K - 1, C), or None at
    K = 1)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(k):   # the reference's sum(), term by term
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out + b[None, None, :]), new_state


def mamba2_mix(p, x: torch.Tensor, cfg,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, *,
               use_kernel: bool = True):
    """SSD recurrence over time.  x (B, S, d); state (conv (B, K - 1, C),
    ssm (B, nh, hd, n) fp32) or None.  Returns (out (B, S, d), (new conv,
    new ssm))."""
    b, s, d = x.shape
    dt_ = x.dtype
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    proj = x @ p["in_proj"].to(dt_)
    z, xbc, dt = proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * n], proj[..., 2 * d_in + 2 * n:]
    conv_state = None if state is None else state[0]
    xbc, new_conv = causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_), conv_state)
    xs, B, C = xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B, S, H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    dA = torch.exp(dt * A[None, None, :])                        # (B, S, H)
    xh = xs.reshape(b, s, nh, hd).float()
    Bf, Cf = B.float(), C.float()
    dBx = (dt[..., None, None] * xh[..., :, None]) * Bf[:, :, None, None, :]  # (B,S,H,hd,n)
    S = (torch.zeros(b, nh, hd, n, dtype=torch.float32, device=x.device)
         if state is None else state[1].float())
    ys = []
    for t in range(s):
        S = dA[:, t, :, None, None] * S + dBx[:, t]
        ys.append(torch.einsum("bhdn,bn->bhd", S, Cf[:, t]))
    y = torch.stack(ys, dim=1)                                   # (B, S, H, hd)
    y = y + p["D"].float()[None, None, :, None] * xh
    y = y.reshape(b, s, d_in).to(dt_)
    y = rmsnorm(y * F.silu(z), p["norm_w"], INNER_NORM_EPS, use_kernel)
    out = y @ p["out_proj"].to(dt_)
    if new_conv is None:
        new_conv = torch.zeros(b, cfg.ssm_conv - 1, d_in + 2 * n, dtype=dt_, device=x.device)
    return out, (new_conv, S)
