"""Threefry-2x32 keys and uniform draws, bit-equal to ``jax.random``.

The JAX package draws the stochastic rounding of quantized gradients
(ops/quantize.py) from ``jax.random`` with its defaults: the
threefry2x32 generator, ``jax_threefry_partitionable=True``, and 32-bit
seeds. This module reproduces the functions it uses — ``PRNGKey``,
``fold_in``, ``split`` and ``uniform`` in float32 — so the port draws
the same bits and quantizes to the same levels. Random123's Threefry-2x32
with 20 rounds (Salmon et al., SC 2011), as jax/_src/prng.py lowers it.

A key is a [2] host (CPU) tensor of uint32 values held in int64: keys
are derived on the host, and only ``random_bits`` / ``uniform`` run on
the device they are asked for, with the key words as plain scalars, so
no draw reads anything back from the card. All arithmetic is plain
torch integer math on int64, masked to 32 bits, so the CPU and the card
give the same bits; this is host-side generator glue, not a kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000     # float32 1.0: exponent of [1, 2)

Device = Union[str, torch.device, None]


def _u32(x) -> torch.Tensor:
    return x & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under
    ``key`` — jax/_src/prng.py ``_threefry2x32_lowering``: five groups
    of four rounds, a key injection after each."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = _u32(x0.to(torch.int64) + ks[0])
    b = _u32(x1.to(torch.int64) + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            a = _u32(a + b)
            b = _rotl(b, r) ^ a
        a = _u32(a + ks[(i + 1) % 3])
        b = _u32(b + ks[(i + 2) % 3] + i + 1)
    return a, b


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers: the key is
    (seed >> 32, seed & 0xFFFFFFFF) of the seed as an int32, i.e.
    (0, the seed's low 32 bits)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data) under ``key``."""
    z = torch.zeros(1, dtype=torch.int64)
    a, b = threefry2x32(key, z, z + (int(data) & _M32))
    return torch.cat([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2]: key i is the hash of
    the counter pair (0, i) (the partitionable "fold-like" split)."""
    i = torch.arange(num, dtype=torch.int64)
    a, b = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([a, b], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device: Device = None) -> torch.Tensor:
    """32 random bits per element (partitionable mode): element i (flat,
    row-major) is hi ^ lo of the hash of the counter pair (i >> 32,
    i & 0xFFFFFFFF). Returned as int64 values in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(key, i >> 32, i & _M32)
    return (a ^ b).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int],
            device: Device = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top
    23 random bits as the mantissa under the exponent of 1.0, minus
    1.0."""
    bits = (random_bits(key, shape, device) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
