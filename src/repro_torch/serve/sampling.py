"""Sampling at temperature > 0 with the reference's keys, in torch.

Counterpart of the sampling in ``repro.serve.engine`` (``sample_token``
and the engine's ``sample_at``): row i of a batch draws with the key
``fold_in(fold_in(PRNGKey(seed), uid_i), P_i)``, P_i being the position
the sampled token will occupy, and the token is
``jax.random.categorical(key, logits.astype(f32) / temperature)``, i.e.
``argmax(gumbel(key, (V,)) + logits / T)``.  A token is therefore a pure
function of (seed, uid, position, logits): admission order, slot count,
preemption and speculation windows do not move it.

The PRNG is JAX's threefry2x32 with ``jax_threefry_partitionable`` on
(JAX's default since 0.5):

  ``prng_key(s)``        ``[0, s mod 2**32]``
  ``fold_in(k, d)``      ``threefry2x32(k, (0, d mod 2**32))``
  ``random_bits(k, s)``  one threefry2x32 per element on the (hi, lo)
                         halves of its flat index, then ``y0 ^ y1``
  ``uniform``            ``bits >> 9 | 0x3F800000`` viewed as f32, minus
                         1, then ``max(lo, x * (1 - lo) + lo)``
  ``gumbel``             ``-log(-log(uniform(lo=tiny, hi=1)))``

Every 32-bit word lives in an int64 tensor holding a uint32 value (the
installed torch's uint32 has no add or shift on the CPU), masked where
the value must be exact; right shifts of such values are logical.  The
bits and the uniforms equal JAX's bit for bit on any device.  ``log`` is
the library's own, so a Gumbel value may differ from XLA's by an ulp
(within ``GUMBEL_ATOL``), which can flip a draw only where the top two
scores lie that close.

All of it is plain torch ops with no host round trip: a captured decode
step computes the keys on the card from its ``uids`` and ``pos``
buffers.

The temperature scaling follows the reference's rounding where it runs:
its eager calls (the first token after a prefill, ``sample_token``)
divide by T in f32, while inside its jitted decode and speculative steps
XLA turns the division by the constant T into a multiply by f32(1/T).
The two differ in the last bit for ~10 % of logits at T 0.7, so
:func:`sample_at` takes ``reciprocal`` to say which one a call site
reproduces.
"""

from __future__ import annotations

from typing import Sequence

import torch

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = torch.finfo(torch.float32).tiny
# |gumbel - XLA's gumbel| for the same key: the two libraries' log
# differ by up to one ulp (9.5e-7 seen over 151 936 draws on the CPU)
GUMBEL_ATOL = 2e-6


def _u32(x) -> torch.Tensor:
    """An int tensor's values mod 2**32, as int64."""
    return x.to(torch.int64) & M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the count pair (x0, x1) under the key
    (k0, k1), all int64 tensors of uint32 values (broadcast together).
    Returns the pair (y0, y1), int64 of uint32 values.

    Between rounds x0 is left unmasked (it only grows, well inside
    int64): its low 32 bits are all that the xor and the sums read, and
    the xor's mask keeps x1 exact, as the rotation needs."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << r
            x1 = ((y | (y >> 32)) ^ x0) & M32      # rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0 & M32, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s raw key: int64 (2,) ``[0, seed mod
    2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) and data (...) integers
    (taken mod 2**32, as the reference's uint32 cast) -> keys (..., 2)."""
    data = _u32(torch.as_tensor(data, device=key.device))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 of uint32 values), shape
    ``key.shape[:-1] + shape``: each key's ``jax.random.bits(key, shape)``
    (threefry on the 64-bit flat index's (hi, lo) halves, ``y0 ^ y1``)."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    kshape = lead + (1,) * len(shape)
    k0, k1 = key[..., 0].reshape(kshape), key[..., 1].reshape(kshape)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, 1.0)``'s transform
    of 32 random bits: 23 mantissa bits under exponent 0 give [1, 2),
    minus 1, then ``max(minval, x * (1 - minval) + minval)``.  For the
    bounds the sampler uses, minval 0 or f32's tiny, ``1 - minval`` is 1
    in f32 and the scaling is exact, however it is fused; other bounds
    are not ported.  The constant is a Python number: no host-to-device
    copy, so a captured step may call it."""
    if not 0.0 <= minval <= 2.0 ** -25:     # where f32(1 - minval) == 1
        raise ValueError(f"uniform on [minval, 1) is ported for minval 0 or "
                         f"tiny only; got {minval}")
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f + minval).clamp_min(minval)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, 1.0)`` for each
    key of ``key`` (..., 2)."""
    return uniform_from_bits(random_bits(key, shape), minval)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") for each
    key: ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    u = uniform(key, shape, F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` in f32: argmax of
    Gumbel noise plus the logits (the first index on ties).  A single key
    (2,) draws the noise for the whole ``logits`` shape, as the
    reference does; keys (..., 2) with ``key.shape[:-1] ==
    logits.shape[:-1]`` draw each row with its own key (the reference's
    vmap).  Returns int64 indices."""
    logits = logits.float()
    shape = logits.shape if key.dim() == 1 else logits.shape[-1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)


def scale_logits(logits: torch.Tensor, temperature: float,
                 reciprocal: bool = False) -> torch.Tensor:
    """``logits.astype(f32) / temperature`` with the reference's rounding
    at the call site.  An eager JAX call divides; inside a jitted step
    XLA rewrites the division by the constant into a multiply by its f32
    reciprocal ``f32(1) / f32(T)`` (``reciprocal=True``), which rounds
    otherwise for most T that are not powers of two.  The operand is a
    one-element f32 tensor on the logits' device, filled in place: a CUDA
    tensor divided by a Python scalar is multiplied by its reciprocal,
    which is not the eager reference's rounding."""
    t32 = torch.tensor(temperature, dtype=torch.float32)
    if reciprocal:
        r = (torch.ones((), dtype=torch.float32) / t32).item()
        return logits.float() * torch.full((1,), r, dtype=torch.float32,
                                           device=logits.device)
    return logits.float() / torch.full((1,), t32.item(), dtype=torch.float32,
                                       device=logits.device)


def sample_at(logits: torch.Tensor, positions: torch.Tensor, uids: torch.Tensor,
              base: torch.Tensor, temperature: float,
              reciprocal: bool = False) -> torch.Tensor:
    """Per-row reproducible sampling, the reference engine's ``sample_at``:
    logits (N, V), positions (N,) and uids (N,) integers, ``base`` the
    engine's ``prng_key(seed)``.  Row i draws with the key
    ``fold_in(fold_in(base, uids[i]), positions[i])`` from
    ``logits[i] / temperature`` (``reciprocal``: as the reference's
    jitted steps scale, see :func:`scale_logits`); temperature <= 0 is
    argmax.  Returns int32 tokens (N,)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return StepSampler(base, temperature, reciprocal)(logits, positions, uids)


class StepSampler:
    """:func:`sample_at` split in two, so that a step can draw the Gumbel
    noise of every position it will sample once (:meth:`noise`) and add
    it to each logits row as that row is computed (:meth:`draw`).  A
    speculative window samples its draft row i and its target row i at
    the same (uid, pos + i + 1) key, so they share one noise row: the
    spec step draws the noise of all T positions at its start, and no
    draft call draws its own.  The captured steps scale as the
    reference's jitted steps do (``reciprocal`` True, the default)."""

    def __init__(self, base: torch.Tensor, temperature: float, reciprocal: bool = True):
        if temperature <= 0.0:
            raise ValueError(f"a sampled step needs temperature > 0; got {temperature}")
        self.base = base
        self.temperature = float(temperature)
        self.reciprocal = reciprocal

    def noise(self, positions: torch.Tensor, uids: torch.Tensor, vocab: int) -> torch.Tensor:
        """Gumbel noise (*positions.shape, vocab) in f32, each row at its
        (uid, position) key (``uids`` broadcasts against ``positions``)."""
        return gumbel(fold_in(fold_in(self.base, uids), positions), (vocab,))

    def draw(self, noise: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """int32 tokens: argmax over the last axis of ``noise`` plus the
        scaled ``logits`` (of ``noise``'s shape; the first index on ties)."""
        scaled = scale_logits(logits, self.temperature, self.reciprocal)
        return torch.argmax(noise + scaled, dim=-1).to(torch.int32)

    def __call__(self, logits: torch.Tensor, positions: torch.Tensor,
                 uids: torch.Tensor) -> torch.Tensor:
        return self.draw(self.noise(positions, uids, logits.shape[-1]), logits)
