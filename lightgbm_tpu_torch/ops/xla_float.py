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
- ``log1p_f32(x)``: XLA:CPU's float32 ``log1p``: a rational
  approximation for |x| < sqrt(2) - 1 and, above it, its inlined
  float32 ``log`` of 1 + x (the exponent and a mantissa in
  [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three interleaved
  Horner chains, and ln 2 in two parts), with the multiply-adds that
  LLVM contracts as FMAs.
- ``softmax_f32(x, dim)``: ``jax.nn.softmax``: the max, XLA's exp of
  x - max, the class terms summed in order, one true division.
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
# log1p: below |x| = sqrt(2) - 1 (rounded to float32) the rational
# approximation num(x) / den(x) (coefficients highest degree last, as
# the Horner chains run); above it log(1 + x): the mantissa's split at
# sqrt(1/2), the nine polynomial coefficients of its three chains, and
# ln 2 as hi + lo
_LOG1P_SMALL = float.fromhex("0x1.A8279Ap-2")
_LOG1P_DEN = tuple(float.fromhex(c) for c in (
    "0x1.E2035Ap+3", "0x1.4C30B6p+6", "0x1.BB865Ap+7", "0x1.351946p+8",
    "0x1.B0DB14p+7", "0x1.E0F304p+5"))
_LOG1P_NUM = tuple(float.fromhex(c) for c in (
    "0x1.7BC096p-15", "0x1.FE818Ap-2", "0x1.A509F4p+2", "0x1.DE9738p+4",
    "0x1.E798ECp+5", "0x1.C8E75Ap+5", "0x1.40A202p+4"))
_LOG_SQRTH = float.fromhex("0x1.6A09E6p-1")
_LOG_POLY = tuple(float.fromhex(c) for c in (
    "0x1.204376p-4", "-0x1.D7A370p-4", "-0x1.FCBA9Ep-4", "0x1.23D37Ep-3",
    "0x1.999D58p-3", "-0x1.FFFFF8p-3", "0x1.DE4A34p-4", "-0x1.555CA0p-3",
    "0x1.555554p-2"))
_LOG_LN2_LO = float.fromhex("-0x1.BD0106p-13")
_LOG_LN2_HI = float.fromhex("0x1.63p-1")


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


def _log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's inlined float32 ``log`` of a float32 tensor, as it runs
    inside ``log1p`` (jaxlib 0.9.0): NaN below 0, -inf at 0, inf at
    inf."""
    f32 = torch.float32
    bits = torch.clamp(v, min=_F32_MIN_NORMAL).view(torch.int32)
    ef = (((bits >> 23) & 0x1FF) - 127).to(f32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)       # in [0.5, 1)
    low = m < _LOG_SQRTH
    z = (m - 1.0) + torch.where(low, m, 0.0)
    ef = ef - torch.where(low, 1.0, 0.0)
    z2 = z * z
    z3 = z2 * z
    c = _LOG_POLY
    p1, p2, p3 = (fma_f32(fma_f32(z, c[2 * j], c[2 * j + 1]), z, c[6 + j])
                  for j in range(3))
    t = fma_f32(fma_f32(p1, z3, p2), z3, p3)
    w = fma_f32(t, z3, ef * _LOG_LN2_LO)
    out = fma_f32(ef, _LOG_LN2_HI, fma_f32(-z2, 0.5, z) + w)
    out = torch.where((v <= 0) | torch.isnan(v), math.nan, out)
    out = torch.where(v == 0, -math.inf, out)
    return torch.where(v == math.inf, math.inf, out)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p with the bits of ``jax.jit(jnp.log1p)`` on the CPU
    (jaxlib 0.9.0), for a float32 tensor on any device; subnormal
    inputs and results are zeros, as there."""
    x = flush_f32(x.to(torch.float32))
    x2 = x * x
    # the Horner chains start from x * 0 + c (0 for finite x)
    den = fma_f32(x, 0.0, 1.0)
    for coef in _LOG1P_DEN:
        den = fma_f32(den, x, coef)
    num = fma_f32(x, 0.0, _LOG1P_NUM[0])
    for coef in _LOG1P_NUM[1:]:
        num = fma_f32(num, x, coef)
    small = x + fma_f32(x2, -0.5, (x * x2) * (num / den))
    out = torch.where(torch.abs(x) < _LOG1P_SMALL, small, _log_f32(x + 1.0))
    return flush_f32(out)


def softmax_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax`` over ``dim`` with the bits of XLA:CPU's float32
    code (jaxlib 0.9.0): exp(x - max) with ``exp_f32``, the terms summed
    in order along ``dim``, one true division, subnormal results
    flushed."""
    x = x.to(torch.float32)
    e = exp_f32(x - torch.amax(x, dim=dim, keepdim=True))
    total = torch.zeros_like(e.select(dim, 0))
    for k in range(e.shape[dim]):
        total = total + e.select(dim, k)
    return flush_f32(e / total.unsqueeze(dim))
