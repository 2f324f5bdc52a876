"""Gradient/hessian quantization for integer histogram training.

The port of the JAX package's ops/quantize.py (quantized training of
Shi et al., NeurIPS 2022; the reference's ``use_quantized_grad``,
gradient_discretizer.cpp). Once per tree the float32 gradients and
hessians are scaled by per-iteration constants and rounded — by
default stochastically, ``floor(x + u)`` with ``u`` uniform on [0, 1)
from ops/threefry.py, the same bits as the JAX package's
``jax.random.uniform`` — to small signed / unsigned levels:

    grad_scale = max|g| / (num_bins/2 - 1)     qg = round(g / grad_scale)
    hess_scale = max h  / (num_bins - 1)       qh = round(h / hess_scale)

The histogram kernels sum those levels exactly in int32, and the
(sum_qg, sum_qh) pairs meet float arithmetic only at the split scan
(ops/split.py ``dequantize_hist``). ``num_bins`` <= 64 keeps every sum
exact: |qg| <= 31, qh <= 63, and a cell's int32 sum holds 2^31 / 63 >
34M rows.

A (qg, qh) pair packs into one int32 word, ``(qg << 16) | (qh &
0xFFFF)``: the fused learner writes that word into the grad plane of
the planar state, and the kernels unpack each row before adding it.
A SUM of packed words still unpacks exactly while ``count * (num_bins -
1) < 2^16`` (``packed_rows_ok``).

``PrefetchedQuant`` is the JAX package's dispatch-ahead ring: the
host-loop booster enqueues every class tree's quantization as soon as
its gradients exist, so the levels of tree c+1 are computed on the card
while tree c's host-driven growth is still running. It stays on the
current stream: each pass takes its own tree's key, in the inline
order, so the levels are the inline pass's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import threefry
from .xla_float import f32_reciprocal

# one packed (qg, qh) word per row
PACKED_BYTES_PER_ROW = 4


def note_requantize(num_bins: int, passes: int = 1) -> None:
    """Count a quantization pass in the active telemetry registry
    (hist.quant_* counters, obs schema minor 2); no-op when telemetry
    is off."""
    from .. import obs
    obs.inc("hist.quant_requantize_passes", passes)
    obs.set_gauge("hist.quant_bins", num_bins)


def grad_levels(num_bins: int) -> Tuple[int, int]:
    """(signed grad level max, unsigned hess level max)."""
    return num_bins // 2 - 1, num_bins - 1


def packed_rows_ok(count: int, num_bins: int) -> bool:
    """True when a packed-word sum over ``count`` rows cannot carry out
    of the low 16-bit hessian field (sum qh <= count * (num_bins-1))."""
    return count * (num_bins - 1) < (1 << 16)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       num_bins: int, key: Optional[torch.Tensor],
                       stochastic: bool = True, grad_max=None,
                       hess_max=None, reciprocal: bool = False):
    """One quantization pass. grad/hess: [n] float32 (pad rows already
    zeroed); ``key``: a threefry key (ops/threefry.py), needed when
    ``stochastic``. Returns (qg, qh, grad_scale, hess_scale): int32
    levels and 0-d float32 scales on the gradients' device. The scales
    are floored at 1e-35 so an all-zero iteration divides safely (its
    levels are all zero either way); ``grad_max`` / ``hess_max``
    override the local maxima. ``reciprocal``: divide the maxima by the
    level counts as XLA does inside a jitted program, a product with the
    float32 reciprocal (the JAX package's fused learner); else a true
    division (its host loop quantizes outside the learner's program)."""
    qmax_g, qmax_h = grad_levels(num_bins)
    grad = grad.to(torch.float32)
    hess = hess.to(torch.float32)
    if grad_max is None:
        grad_max = torch.max(torch.abs(grad))
    if hess_max is None:
        hess_max = torch.max(hess)
    def scale(vmax, qmax):
        # tpulint: sync-ok(vmax is a device tensor here: as_tensor copies nothing)
        v = torch.clamp(torch.as_tensor(vmax, dtype=torch.float32,
                                        device=grad.device), min=1e-35)
        if reciprocal:
            return v * f32_reciprocal(qmax)
        # a tensor divisor: torch divides a CUDA tensor by a Python
        # number as a product with its reciprocal (filled on the card:
        # no copy from the host)
        return v / torch.full((), float(qmax), dtype=torch.float32,
                              device=v.device)
    gscale, hscale = scale(grad_max, qmax_g), scale(hess_max, qmax_h)
    sg = grad / gscale
    sh = hess / hscale
    if stochastic:
        kg, kh = threefry.split(key)
        # floor(x + u), u ~ U[0, 1): unbiased stochastic rounding
        sg = torch.floor(sg + threefry.uniform(kg, sg.shape, grad.device))
        sh = torch.floor(sh + threefry.uniform(kh, sh.shape, grad.device))
    else:
        sg = torch.round(sg)        # half to even, as jnp.round
        sh = torch.round(sh)
    qg = torch.clamp(sg, -qmax_g, qmax_g).to(torch.int32)
    qh = torch.clamp(sh, 0, qmax_h).to(torch.int32)
    return qg, qh, gscale, hscale


class PrefetchedQuant:
    """Two-slot dispatch-ahead quantization ring (the JAX package's).

    The producer (the booster's host loop) pushes the quantization of an
    upcoming tree as soon as that tree's gradients exist; the consumer
    (the tree grower) pops it when the tree grows. Slots match by key
    index AND (grad, hess) object identity, so a tree can never be
    paired with another tree's stochastic-rounding draw; a mismatch
    falls back to the inline pass, which gives the same bits.
    """

    def __init__(self, depth: int = 2) -> None:
        self.depth = max(1, int(depth))
        self.slots: list = []    # (key index, grad, hess, result)

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def full(self) -> bool:
        return len(self.slots) >= self.depth

    def push(self, idx: int, grad, hess, result) -> None:
        self.slots.append((idx, grad, hess, result))

    def pop_match(self, idx: int, grad, hess):
        """The prefetched result for (idx, grad, hess), or None. Stale
        slots (an older index or other tensors) are dropped on the way:
        the ring never reorders the key sequence."""
        while self.slots:
            s = self.slots.pop(0)
            if s[0] == idx and s[1] is grad and s[2] is hess:
                return s[3]
        return None

    def clear(self) -> None:
        self.slots = []


def pack_gh(qg: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """[n] int32 packed words: qg in the high 16 bits (sign-carrying),
    qh in the low 16 (always non-negative, so no borrow on unpack)."""
    return ((qg.to(torch.int32) << 16)
            | (qh.to(torch.int32) & 0xFFFF)).to(torch.int32)


def unpack_gh(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_gh — also exact on packed-word SUMS while the
    low field has not overflowed (see packed_rows_ok)."""
    qh = w & 0xFFFF
    qg = w >> 16    # arithmetic shift: restores the sign of qg
    return qg, qh


def packed_hist_to_pairs(packed: torch.Tensor) -> torch.Tensor:
    """[..., F, B] summed packed words -> [..., F, B, 2] int32 pairs."""
    qg, qh = unpack_gh(packed)
    return torch.stack([qg, qh], dim=-1)


def pairs_to_packed_hist(hist: torch.Tensor) -> torch.Tensor:
    """[..., F, B, 2] int32 pairs -> [..., F, B] packed words (valid for
    transport when the hessian sums fit 16 bits)."""
    return pack_gh(hist[..., 0], hist[..., 1])
