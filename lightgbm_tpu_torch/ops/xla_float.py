"""XLA:CPU's float32 arithmetic that the port reproduces bit for bit.

The JAX package runs its objective and split scan under ``jit`` on the
CPU, where XLA (jaxlib 0.9.0) lowers ``jnp.exp`` for float32 to an
inlined Cephes-style polynomial rather than a libm call, and where the
LLVM backend contracts a multiply feeding an add into one fused
multiply-add (FMA) although the IR carries no ``contract`` flags. To
give the JAX package's bits, on the CPU and on the card alike, the port
computes those steps here from plain torch ops:

- ``fma_f32(a, b, c)``: a float32 FMA, correctly rounded once, built
  from float64 operations (the product of two float32 values is exact
  in float64; the sum is rounded to odd so that its final rounding to
  float32 is correct). IEEE float64 gives the same bits on every device.
- ``exp_f32(x)``: XLA:CPU's float32 ``exp`` (jaxlib 0.9.0): clamp,
  range reduction by ln 2 in two parts, a degree-5 polynomial, and the
  scale by 2^n built from the exponent bits, with XLA's fused steps as
  FMAs.
- ``flush_f32(x)``: XLA:CPU runs its computations with the x86
  flush-to-zero and denormals-are-zero modes on, so a float32 result
  below 2^-126 in magnitude becomes a zero of its sign; the port flushes
  where such a result can arise (the gradients of scores far from 0).

To check an FMA site of the JAX package, dump XLA's code
(``XLA_FLAGS=--xla_dump_to=DIR``, file
``*.ir-with-opt.ll``) and compare the candidate with the jitted JAX
function on random inputs, bit for bit.
"""
from __future__ import annotations

import math

import torch

# clamp bounds of x, log2(e), ln 2 split in two (hi exact in 9 bits),
# and the polynomial's coefficients, highest degree first (float32)
_F32_MIN_NORMAL = float.fromhex("0x1p-126")
_EXP_LO = float.fromhex("-0x1.5F3334p+6")
_EXP_HI = float.fromhex("0x1.633334p+6")
_LOG2E = float.fromhex("0x1.715476p+0")
_LN2_HI = float.fromhex("0x1.63p-1")
_LN2_LO = float.fromhex("-0x1.BD0106p-13")
_EXP_POLY = tuple(float.fromhex(c) for c in (
    "0x1.A0D2CEp-13", "0x1.6E879Cp-10", "0x1.111210p-7", "0x1.555382p-5",
    "0x1.555554p-3", "0x1.0p-1"))


def f32_value(x: float) -> float:
    """A Python float rounded to the nearest float32 value."""
    return torch.tensor(x, dtype=torch.float32).item()


def f32_reciprocal(x: float) -> float:
    """1 / x in float32 arithmetic: XLA divides by a constant as a
    product with this reciprocal."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(x, dtype=torch.float32)).item()


def flush_f32(x: torch.Tensor) -> torch.Tensor:
    """A float32 result as XLA:CPU leaves it: subnormals flushed to a
    zero of their sign."""
    return torch.where(torch.abs(x) < _F32_MIN_NORMAL, x * 0.0, x)


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (a fused multiply-add). The
    operands are float32 tensors, or Python floats taken as float32
    values; they broadcast together."""
    a, b, c = (t.to(torch.float64) if torch.is_tensor(t) else f32_value(t)
               for t in (a, b, c))
    p = a * b                      # exact: 24 + 24 significant bits
    s = p + c
    # TwoSum: s + e == p + c exactly
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    # round to odd: an inexact s with an even last bit moves one ulp
    # towards the exact sum, so rounding to float32 does not round twice
    even = (s.view(torch.int64) & 1) == 0
    fix = (e != 0) & even & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp with the bits of ``jax.jit(jnp.exp)`` on the CPU
    (jaxlib 0.9.0), for a float32 tensor on any device."""
    x = torch.clamp(x.to(torch.float32), _EXP_LO, _EXP_HI)   # NaN passes
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(-_LN2_HI, n, x)
    r = fma_f32(-_LN2_LO, n, r)
    p = fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for coef in _EXP_POLY[2:]:
        p = fma_f32(p, r, coef)
    y = 1.0 + fma_f32(p, r * r, r)
    # 2^n from the exponent bits (n = -127 gives 0: exp underflows);
    # NaN gives a NaN y, whatever the scale
    ni = torch.nan_to_num(n, nan=0.0).to(torch.int32)
    scale = ((ni + 127) << 23).view(torch.float32)
    return flush_f32(y * scale)
