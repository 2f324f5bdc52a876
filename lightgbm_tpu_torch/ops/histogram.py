"""Gradient/hessian histograms.

The port of the JAX package's ops/histogram.py, as far as the training
main path needs it. Histograms hold (sum_gradient, sum_hessian) per
(feature, bin) as ``[F, B, 2]`` float32; bin counts are recovered at
split-scan time as ``round(hess * num_data / sum_hess)``, like the
reference (feature_histogram.hpp cnt_factor).

- ``histogram_scatter``: the row-major oracle (``index_add_``).
- ``histogram_planar_plain``: the leaf-window histogram straight off the
  planar state in plain PyTorch — unpack, mask, ``index_add_``.
- ``hist_planar_cuda``: the same function as a hand-written CUDA kernel
  (csrc/hist_planar.cu), the counterpart of the JAX package's
  histogram_planar_pallas; a CPU tensor takes the plain version.
- ``hist_layout`` / ``hist_method``: the one layout and precision
  dispatch shared by the learner.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import cuda as K

Window = Union[int, torch.Tensor]


def histogram_scatter(bins: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Scatter-add histogram (oracle). bins: [C, F] integer bin codes;
    grad/hess: [C] float32. Returns [F, B, 2] float32."""
    c, f = bins.shape
    idx = (torch.arange(f, device=bins.device)[None, :] * num_bins
           + bins.to(torch.int64)).reshape(-1)
    vals = torch.stack([grad, hess], dim=-1).to(torch.float32)    # [C, 2]
    vals = vals[:, None, :].expand(c, f, 2).reshape(-1, 2)
    hist = torch.zeros((f * num_bins, 2), dtype=torch.float32,
                       device=bins.device)
    hist.index_add_(0, idx, vals)
    return hist.reshape(f, num_bins, 2)


def unpack_codes(words: torch.Tensor, num_cols: int, code_bits: int
                 ) -> torch.Tensor:
    """[code_planes, W] int32 packed planes -> [W, num_cols] int64 codes
    (little-endian: column f in plane f*bits//32 at bit f*bits%32)."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    f = torch.arange(num_cols, device=words.device)
    bitpos = f * code_bits
    sel = u[bitpos // 32]                                        # [G, W]
    codes = (sel >> (bitpos % 32)[:, None]) & ((1 << code_bits) - 1)
    return codes.t()


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# rows per tile of the CUDA kernel's first pass (csrc/hist_planar.cu
# kTile); the plain version sums in the same association
HIST_TILE = 2048


def histogram_planar_plain(data: torch.Tensor, start: Window, count: Window,
                           *, num_bins: int, num_cols: int, code_bits: int,
                           grad_plane: int,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Leaf-window histogram of the planar state in plain PyTorch:
    unpack, mask, ``index_add_``. ``dtype=torch.bfloat16`` rounds
    grad/hess to bfloat16 (round to nearest even) before the float32
    accumulation.

    Sums are taken in the CUDA kernel's association: a histogram per
    tile of HIST_TILE rows (rows in order), then the tiles added in
    order. On the CPU, where ``index_add_`` runs in index order, the
    result is bit-identical to the kernel's."""
    start, count = int(start), int(count)
    win = data[:, start:start + count]
    codes = unpack_codes(win, num_cols, code_bits)
    g = win[grad_plane].view(torch.float32)
    h = win[grad_plane + 1].view(torch.float32)
    if dtype == torch.bfloat16:
        g, h = _round_bf16(g), _round_bf16(h)
    out = torch.zeros((num_cols, num_bins, 2), dtype=torch.float32,
                      device=data.device)
    for t0 in range(0, count, HIST_TILE):
        sl = slice(t0, t0 + HIST_TILE)
        out = out + histogram_scatter(codes[sl], g[sl], h[sl], num_bins)
    return out


def hist_planar_cuda(data: torch.Tensor, start: Window, count: Window, *,
                     num_bins: int, num_cols: int, code_bits: int,
                     grad_plane: int, dtype: torch.dtype = torch.float32,
                     max_count: Optional[int] = None,
                     quant: bool = False) -> torch.Tensor:
    """Histogram [num_cols, num_bins, 2] float32 of the lane window
    [start, start+count) of the planar state ``data`` [P, R] int32.

    ``start``/``count`` are host ints, or 0-d int32 tensors on the card
    that the kernel reads itself — then ``max_count`` (a host int) must
    bound the count; it sizes the launch. ``dtype`` is float32 or
    bfloat16 (grad/hess rounded before the float32 accumulation).

    A tensor on the card launches the CUDA kernel
    (csrc/hist_planar.cu); a CPU tensor takes histogram_planar_plain.
    The packed-integer ``quant`` mode is not ported yet (ROADMAP A10)."""
    if quant:
        raise NotImplementedError(
            "quantized histograms are not ported yet (ROADMAP A10)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if code_bits not in (4, 8, 16):
        raise ValueError(f"code_bits must be 4, 8 or 16, got {code_bits}")
    if not data.is_cuda:
        return histogram_planar_plain(
            data, start, count, num_bins=num_bins, num_cols=num_cols,
            code_bits=code_bits, grad_plane=grad_plane, dtype=dtype)
    if data.dtype != torch.int32 or data.dim() != 2 \
            or not data.is_contiguous():
        raise ValueError("hist_planar_cuda needs a contiguous [P, R] int32 "
                         "state")
    P, R = data.shape
    if grad_plane + 1 >= P or -(-num_cols * code_bits // 32) > grad_plane:
        raise ValueError("grad/hess planes must follow the code planes")
    dev = data.device
    on_device = torch.is_tensor(start)
    if on_device != torch.is_tensor(count):
        raise ValueError("start and count must both be ints or both tensors")
    if on_device:
        for t in (start, count):
            if t.device != dev or t.dtype != torch.int32 or t.numel() != 1:
                raise ValueError("window tensors must be int32 scalars on "
                                 "the state's device")
        if max_count is None:
            raise ValueError("max_count must bound a device-side count")
        start_t, count_t = start.contiguous(), count.contiguous()
        sp, cp, sh, ch = start_t.data_ptr(), count_t.data_ptr(), 0, 0
    else:
        sh, ch = int(start), int(count)
        if not 0 <= sh <= sh + ch <= R:
            raise ValueError(f"window [{sh}, {sh + ch}) outside [0, {R})")
        sp = cp = None
        max_count = ch if max_count is None else max_count
    max_count = min(int(max_count), R)
    lib = K.lib("hist_planar")
    tile = lib.lgbt_hist_tile()
    grid_tiles = max(1, -(-max_count // tile))
    partials = torch.empty(grid_tiles * num_cols * num_bins * 2,
                           dtype=torch.float32, device=dev)
    out = torch.empty((num_cols, num_bins, 2), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K.check(lib.lgbt_hist_planar(
        data.data_ptr(), R, sp, cp, sh, ch, max_count, num_cols, num_bins,
        code_bits, grad_plane, int(dtype == torch.bfloat16),
        partials.data_ptr(), out.data_ptr(), stream), "hist_planar_cuda")
    K.LAUNCHES["hist_planar"] += 1
    return out


def hist_layout(config, dataset=None) -> str:
    """Occupancy-driven histogram LAYOUT decision: "planar" or
    "multival" (the JAX package's rule, unchanged): ``tpu_hist_layout``
    overrides; "auto" picks multival exactly when the shape is wide AND
    sparse."""
    from .multival import MULTIVAL_MAX_OCCUPANCY, MULTIVAL_MIN_GROUPS
    if config.tpu_hist_layout != "auto":
        return config.tpu_hist_layout
    occ = getattr(dataset, "occupancy", None) if dataset is not None \
        else None
    if (occ is not None and occ.num_groups >= MULTIVAL_MIN_GROUPS
            and occ.row_nnz_mean
            <= MULTIVAL_MAX_OCCUPANCY * occ.num_groups):
        return "multival"
    return "planar"


def hist_method(config, dataset=None) -> Optional[torch.dtype]:
    """The ONE histogram precision dispatch of the learner. On the card
    the planar kernel runs in ``tpu_hist_dtype`` (bfloat16 by default,
    as on the TPU); the multi-value layout is not ported yet. On the
    CPU the exact float32 plain path runs regardless — the rule the JAX
    package applies off-TPU (its hist_method returns None there), so the
    CPU gate compares like with like. Returns the histogram input dtype,
    or None for the exact CPU path."""
    if config.device_type == "cpu":
        return None
    if hist_layout(config, dataset) == "multival":
        raise NotImplementedError(
            "the multi-value histogram layout is not ported to the card "
            "yet (ROADMAP A11); set tpu_hist_layout='planar'")
    return (torch.float32 if config.tpu_hist_dtype == "float32"
            else torch.bfloat16)
