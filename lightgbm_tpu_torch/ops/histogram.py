"""Gradient/hessian histograms.

The port of the JAX package's ops/histogram.py. Histograms hold
(sum_gradient, sum_hessian) per (feature, bin) as ``[F, B, 2]``
float32; bin counts are recovered at split-scan time as
``round(hess * num_data / sum_hess)``, like the reference
(feature_histogram.hpp cnt_factor).

Under quantized training (ops/quantize.py) every kernel also has an
integer mode: grad/hess are int32 levels (``hist_radix`` / ``hist_masked``
take it from an integer grad dtype, as the JAX package does) or packed
``(qg << 16) | qh`` words in the planar state's grad plane
(``hist_planar(quant=True)``), and the histogram is ``[F, B, 2]`` int32,
summed exactly. Its plain version is one ``index_add_`` in int32, where
any order gives the same bits.

Every kernel comes as three functions: ``*_plain`` (plain PyTorch, the
port's oracle), ``*_cuda`` (launches the hand-written CUDA kernel and
raises for a tensor that is not on the card) and a dispatcher chosen by
the tensor's device:

- ``hist_planar``: the leaf-window histogram straight off the planar
  state (csrc/hist_planar.cu; the JAX package's
  histogram_planar_pallas).
- ``hist_radix``: the row-major ``[C, F]`` histogram of the serial
  learner, float32 or bfloat16 inputs (csrc/hist_rowmajor.cu; the JAX
  package's histogram_radix_pallas).
- ``hist_masked``: the same row-major contract, float32 only (the second
  entry of csrc/hist_rowmajor.cu; the JAX package's histogram_pallas).

``histogram`` is the JAX package's row-major method dispatch,
``leaf_histogram`` its leaf gather, and ``hist_layout`` / ``hist_method``
the one layout and precision dispatch shared by the learners.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import cuda as K
from .quantize import unpack_gh

Window = Union[int, torch.Tensor]

# rows per tile of csrc/hist_planar.cu's float modes (kTile,
# lgbt_hist_tile): each cell summed in row order inside a tile, the tiles
# in order; its plain version sums in the same association
HIST_TILE = 2048

# the tile rule of csrc/hist_rowmajor.cu's float modes (rm_tile there,
# lgbt_rm_tile): one tile per resident block of a fixed grid, at least
# RM_MIN_TILE rows, and at most RM_MAX_PARTIAL_CELLS partial cells
RM_SMS = 132                  # H100 SXM streaming multiprocessors
RM_BLOCKS_PER_SM = 2          # blocks of 28 column warps at 255 bins
RM_MIN_TILE = 2048
RM_MAX_PARTIAL_CELLS = 1 << 22


def rowmajor_tile(c: int, f: int, num_bins: int) -> int:
    """Rows per tile of the row-major float histogram (B4 / B7) for a
    [c, f] window and ``num_bins`` bins: a function of the shapes alone,
    equal to the CUDA kernel's ``lgbt_rm_tile``. A large window is cut
    into RM_SMS x RM_BLOCKS_PER_SM tiles, one per block the card holds
    at once; a window of up to RM_MIN_TILE rows is one tile, summed in
    plain row order as the JAX package's scatter sums it; the partials
    (tiles x f x num_bins cells) stay within RM_MAX_PARTIAL_CELLS."""
    tile = max(RM_MIN_TILE, -(-c // (RM_SMS * RM_BLOCKS_PER_SM)))
    max_tiles = max(1, RM_MAX_PARTIAL_CELLS // max(1, f * num_bins))
    return max(tile, -(-c // max_tiles))


def _acc_dtype(grad: torch.Tensor) -> torch.dtype:
    """int32 for quantized levels, else float32 (the JAX package's rule:
    integer inputs build exact int32 histograms)."""
    return torch.float32 if grad.is_floating_point() else torch.int32


def histogram_scatter(bins: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Scatter-add histogram (oracle). bins: [C, F] integer bin codes;
    grad/hess: [C] float32, or int32 levels. Returns [F, B, 2] float32,
    or int32 for integer inputs (exact). Codes outside [0, num_bins) add
    nothing."""
    c, f = bins.shape
    acc = _acc_dtype(grad)
    codes = bins.to(torch.int64)
    ok = (codes >= 0) & (codes < num_bins)
    idx = (torch.arange(f, device=bins.device)[None, :] * num_bins
           + torch.where(ok, codes, 0)).reshape(-1)
    vals = torch.stack([grad, hess], dim=-1).to(acc)              # [C, 2]
    vals = torch.where(ok[..., None], vals[:, None, :], 0).reshape(-1, 2)
    hist = torch.zeros((f * num_bins, 2), dtype=acc, device=bins.device)
    hist.index_add_(0, idx, vals)
    return hist.reshape(f, num_bins, 2)


def tiled_scatter(codes: torch.Tensor, grad: torch.Tensor,
                  hess: torch.Tensor, num_bins: int,
                  tile: int = HIST_TILE) -> torch.Tensor:
    """[C, F] codes -> [F, B, 2] float32 in the CUDA kernels'
    association: one histogram per tile of ``tile`` rows (each cell
    summed in row order), then the tiles added in order. A code outside
    [0, num_bins) adds nothing. On the CPU, where ``index_add_`` runs in
    index order, the result is bit-identical to the kernels' (B1 with
    the default HIST_TILE, B4 / B7 with ``rowmajor_tile``)."""
    c, f = codes.shape
    dev = codes.device
    out = torch.zeros((f, num_bins, 2), dtype=torch.float32, device=dev)
    if c == 0:
        return out
    ntiles = -(-c // tile)
    codes = codes.to(torch.int64)
    ok = (codes >= 0) & (codes < num_bins)
    tile_of = torch.arange(c, device=dev) // tile
    idx = ((tile_of[:, None] * f + torch.arange(f, device=dev)[None, :])
           * num_bins + torch.where(ok, codes, 0))
    vals = torch.stack([grad, hess], dim=-1).to(torch.float32)
    vals = torch.where(ok[..., None], vals[:, None, :], 0.0)
    parts = torch.zeros((ntiles * f * num_bins, 2), dtype=torch.float32,
                        device=dev)
    parts.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    parts = parts.reshape(ntiles, f, num_bins, 2)
    for t in range(ntiles):
        out = out + parts[t]
    return out


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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")


def _need_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel: its tensors must "
                         "be on the card (the dispatcher without the "
                         "_cuda suffix takes the plain version on the CPU)")


# ---------------------------------------------------------------------------
# B1: planar leaf-window histogram
# ---------------------------------------------------------------------------

def histogram_planar_plain(data: torch.Tensor, start: Window, count: Window,
                           *, num_bins: int, num_cols: int, code_bits: int,
                           grad_plane: int,
                           dtype: torch.dtype = torch.float32,
                           quant: bool = False) -> torch.Tensor:
    """Leaf-window histogram of the planar state in plain PyTorch:
    unpack, then ``tiled_scatter`` in the CUDA kernel's association.
    ``dtype=torch.bfloat16`` rounds grad/hess to bfloat16 (round to
    nearest even) before the float32 accumulation. ``quant``: the grad
    plane holds packed levels; int32 sums by one ``index_add_``."""
    start, count = int(start), int(count)
    win = data[:, start:start + count]
    codes = unpack_codes(win, num_cols, code_bits)
    if quant:
        qg, qh = unpack_gh(win[grad_plane])
        return histogram_scatter(codes, qg, qh, num_bins)
    g = win[grad_plane].view(torch.float32)
    h = win[grad_plane + 1].view(torch.float32)
    if dtype == torch.bfloat16:
        g, h = round_bf16(g), round_bf16(h)
    return tiled_scatter(codes, g, h, num_bins)


def hist_planar_cuda(data: torch.Tensor, start: Window, count: Window, *,
                     num_bins: int, num_cols: int, code_bits: int,
                     grad_plane: int, dtype: torch.dtype = torch.float32,
                     max_count: Optional[int] = None,
                     quant: bool = False) -> torch.Tensor:
    """Histogram [num_cols, num_bins, 2] float32 of the lane window
    [start, start+count) of the planar state ``data`` [P, R] int32, by
    the CUDA kernel csrc/hist_planar.cu.

    ``start``/``count`` are host ints, or 0-d int32 tensors on the card
    that the kernel reads itself — then ``max_count`` (a host int) must
    bound the count; it sizes the launch. ``dtype`` is float32 or
    bfloat16 (grad/hess rounded before the float32 accumulation).
    ``quant``: the grad plane holds packed (qg << 16) | qh words (the
    hess plane is not read) and the histogram is int32, summed
    exactly; ``dtype`` is then ignored."""
    _check_dtype(dtype)
    _need_cuda(data, "hist_planar_cuda")
    if code_bits not in (4, 8, 16):
        raise ValueError(f"code_bits must be 4, 8 or 16, got {code_bits}")
    if data.dtype != torch.int32 or data.dim() != 2 \
            or not data.is_contiguous():
        raise ValueError("hist_planar_cuda needs a contiguous [P, R] int32 "
                         "state")
    P, R = data.shape
    if grad_plane + 1 >= P or -(-num_cols * code_bits // 32) > grad_plane:
        raise ValueError("grad/hess planes must follow the code planes")
    if not 1 <= num_bins <= 1 << 16:
        raise ValueError(f"num_bins {num_bins} outside [1, 65536]")
    dev = data.device
    sp, cp, sh, ch, max_count = _window_args(start, count, max_count, R, dev)
    lib = K.lib("hist_planar")
    if lib.lgbt_hist_tile() != HIST_TILE:
        raise RuntimeError("hist_planar_cuda: the kernel's tile is not "
                           f"HIST_TILE {HIST_TILE}")
    partials = None       # the int32 mode folds blocks by integer atomics
    if not quant:
        partials = torch.empty(
            max(1, -(-max_count // HIST_TILE)) * num_cols * num_bins * 2,
            dtype=torch.float32, device=dev)
    out = torch.empty((num_cols, num_bins, 2),
                      dtype=torch.int32 if quant else torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K.check(lib.lgbt_hist_planar(
        data.data_ptr(), R, sp, cp, sh, ch, max_count, num_cols, num_bins,
        code_bits, grad_plane, int(dtype == torch.bfloat16), int(quant),
        None if partials is None else partials.data_ptr(), out.data_ptr(),
        stream), "hist_planar_cuda")
    K.LAUNCHES["hist_planar_q" if quant else "hist_planar"] += 1
    return out


def hist_planar(data: torch.Tensor, start: Window, count: Window, *,
                num_bins: int, num_cols: int, code_bits: int,
                grad_plane: int, dtype: torch.dtype = torch.float32,
                max_count: Optional[int] = None,
                quant: bool = False) -> torch.Tensor:
    """The planar histogram (the JAX package's histogram_planar_pallas):
    ``hist_planar_cuda`` for a state on the card, its plain version for
    a state on the CPU."""
    _check_dtype(dtype)
    kw = dict(num_bins=num_bins, num_cols=num_cols, code_bits=code_bits,
              grad_plane=grad_plane, dtype=dtype, quant=quant)
    if data.is_cuda:
        return hist_planar_cuda(data, start, count, max_count=max_count,
                                **kw)
    return histogram_planar_plain(data, start, count, **kw)


def _window_args(start: Window, count: Window, max_count: Optional[int],
                 R: int, dev):
    """(start_ptr, count_ptr, start_h, count_h, max_count) of a lane
    window given as host ints or as int32 scalars on the card."""
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
        return (start.contiguous().data_ptr(), count.contiguous().data_ptr(),
                0, 0, min(int(max_count), R))
    # tpulint: capture-ok(host window: device windows return above)
    sh, ch = int(start), int(count)
    # tpulint: capture-ok(host window: device windows return above)
    if not 0 <= sh <= sh + ch <= R:
        raise ValueError(f"window [{sh}, {sh + ch}) outside [0, {R})")
    max_count = ch if max_count is None else max_count
    # tpulint: capture-ok(host window: device windows return above)
    return None, None, sh, ch, min(int(max_count), R)


# ---------------------------------------------------------------------------
# B4 / B7: row-major [C, F] histograms
# ---------------------------------------------------------------------------

def _rowmajor_tiled(bins, grad, hess, num_bins):
    c, f = bins.shape
    return tiled_scatter(bins, grad, hess, num_bins,
                         tile=rowmajor_tile(c, f, num_bins))


def histogram_radix_plain(bins: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, num_bins: int,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Row-major histogram in plain PyTorch: grad/hess rounded to
    bfloat16 when ``dtype`` says so, then ``tiled_scatter`` with the
    kernel's ``rowmajor_tile``; integer levels sum exactly in int32
    (``dtype`` ignored)."""
    if not grad.is_floating_point():
        return histogram_scatter(bins, grad, hess, num_bins)
    grad, hess = grad.to(torch.float32), hess.to(torch.float32)
    if dtype == torch.bfloat16:
        grad, hess = round_bf16(grad), round_bf16(hess)
    return _rowmajor_tiled(bins, grad, hess, num_bins)


def histogram_masked_plain(bins: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, num_bins: int
                           ) -> torch.Tensor:
    """The masked multiply-accumulate histogram in plain PyTorch
    (int32 levels: exact int32 sums)."""
    if not grad.is_floating_point():
        return histogram_scatter(bins, grad, hess, num_bins)
    return _rowmajor_tiled(bins, grad.to(torch.float32),
                           hess.to(torch.float32), num_bins)


def _rowmajor_launch(entry: str, bins, grad, hess, num_bins, bf16: bool):
    _need_cuda(bins, entry)
    if bins.dim() != 2:
        raise ValueError(f"{entry} needs [C, F] bins")
    c, f = bins.shape
    dev = bins.device
    if grad.shape != (c,) or hess.shape != (c,) or grad.device != dev \
            or hess.device != dev:
        raise ValueError("grad/hess must be [C] tensors on the bins' device")
    if not 1 <= num_bins < 0xFFFF or f < 1:
        raise ValueError(f"num_bins {num_bins} / columns {f} out of range")
    codes = bins.contiguous() if bins.dtype == torch.uint8 \
        else bins.to(torch.int32).contiguous()
    acc = _acc_dtype(grad)
    quant = acc == torch.int32
    g = grad.to(acc).contiguous()
    h = hess.to(acc).contiguous()
    lib = K.lib("hist_rowmajor")
    partials = None       # the int32 mode folds blocks by integer atomics
    if not quant:
        tile = rowmajor_tile(c, f, num_bins)
        if lib.lgbt_rm_tile(c, f, num_bins) != tile:
            raise RuntimeError(f"{entry}: the kernel's tile for {c} x {f} "
                               f"x {num_bins} is not rowmajor_tile's {tile}")
        partials = torch.empty(max(1, -(-c // tile)) * f * num_bins * 2,
                               dtype=acc, device=dev)
    out = torch.empty((f, num_bins, 2), dtype=acc, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [codes.data_ptr(), codes.element_size(), c, f, g.data_ptr(),
            h.data_ptr(), num_bins]
    tail = [int(quant), None if partials is None else partials.data_ptr(),
            out.data_ptr(), stream]
    if entry == "hist_radix_cuda":
        K.check(lib.lgbt_hist_radix(*args, int(bf16), *tail), entry)
        name = "hist_radix"
    else:
        K.check(lib.lgbt_hist_masked(*args, *tail), entry)
        name = "hist_masked"
    K.LAUNCHES[name + "_q" if quant else name] += 1
    return out


def hist_radix_cuda(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, num_bins: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[F, B, 2] float32 histogram of [C, F] codes (uint8, or any integer
    type, widened to int32) and [C] grad/hess, by the CUDA kernel
    csrc/hist_rowmajor.cu (entry lgbt_hist_radix). ``dtype`` bfloat16
    rounds grad/hess before the float32 accumulation. Integer grad/hess
    (quantized levels) give an exact int32 histogram."""
    _check_dtype(dtype)
    return _rowmajor_launch("hist_radix_cuda", bins, grad, hess, num_bins,
                            dtype == torch.bfloat16)


def hist_radix(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               num_bins: int, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """The row-major histogram (the JAX package's
    histogram_radix_pallas): the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU; int32 for integer
    grad/hess."""
    _check_dtype(dtype)
    if bins.is_cuda:
        return hist_radix_cuda(bins, grad, hess, num_bins, dtype)
    return histogram_radix_plain(bins, grad, hess, num_bins, dtype)


def hist_masked_cuda(bins: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The row-major histogram by the CUDA kernel csrc/hist_rowmajor.cu
    (entry lgbt_hist_masked): float32 inputs only, or int32 levels for
    an exact int32 histogram."""
    return _rowmajor_launch("hist_masked_cuda", bins, grad, hess, num_bins,
                            False)


def hist_masked(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """The masked multiply-accumulate histogram (the JAX package's
    histogram_pallas): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if bins.is_cuda:
        return hist_masked_cuda(bins, grad, hess, num_bins)
    return histogram_masked_plain(bins, grad, hess, num_bins)


def histogram(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              num_bins: int, method: Optional[str] = None) -> torch.Tensor:
    """Method-dispatched row-major histogram [F, B, 2] (the JAX
    package's ``histogram``). ``None`` and "radix_pallas" take
    ``hist_radix`` in float32 — on the CPU its plain version, which sums
    in the kernel's association, so card and CPU runs agree;
    "radix_pallas_bf16" rounds grad/hess to bfloat16; "pallas" takes
    ``hist_masked``; "scatter" the oracle."""
    if method == "multival_pallas":
        raise ValueError(
            "multival_pallas is not a column-major histogram method; "
            "use ops.multival.leaf_histogram_multival")
    if method in (None, "radix_pallas"):
        return hist_radix(bins, grad, hess, num_bins)
    if method == "radix_pallas_bf16":
        return hist_radix(bins, grad, hess, num_bins, dtype=torch.bfloat16)
    if method == "pallas":
        return hist_masked(bins, grad, hess, num_bins)
    if method == "scatter":
        return histogram_scatter(bins, grad, hess, num_bins)
    raise ValueError(f"unknown histogram method {method!r}")


# ---------------------------------------------------------------------------
# leaf gathers (the serial learner's ordered rows of one leaf)
# ---------------------------------------------------------------------------

def leaf_window(perm: torch.Tensor, start: int, count: int, capacity: int):
    """Capacity-padded window of the permutation covering a leaf (the
    JAX package's leaf_window): when the window would run past the end
    of ``perm`` the read start is clamped left. Returns (rows_raw,
    valid, read_start)."""
    start, count = int(start), int(count)
    n = perm.shape[0]
    read_start = min(start, max(n - capacity, 0))
    rows = perm[read_start:read_start + min(capacity, n)]
    if capacity > n:
        rows = torch.nn.functional.pad(rows, (0, capacity - n))
    off = start - read_start
    pos = torch.arange(capacity, device=perm.device)
    valid = (pos >= off) & (pos < off + count)
    return rows, valid, read_start


def gather_leaf_rows(perm: torch.Tensor, start: int, count: int,
                     capacity: Optional[int] = None):
    """Leaf row ids and their validity mask. With a ``capacity`` the
    JAX package's padded form (non-leaf positions clamped to row 0 and
    flagged invalid); without one, exactly the leaf's rows."""
    if capacity is None:
        start, count = int(start), int(count)
        rows = perm[start:start + count]
        return rows, torch.ones(rows.shape[0], dtype=torch.bool,
                                device=perm.device)
    rows, valid, _ = leaf_window(perm, start, count, capacity)
    return torch.where(valid, rows, 0), valid


def leaf_histogram(bins_full: torch.Tensor, perm: torch.Tensor, start: int,
                   count: int, grad: torch.Tensor, hess: torch.Tensor,
                   capacity: Optional[int], num_bins: int,
                   method: Optional[str] = None) -> torch.Tensor:
    """Histogram of one leaf's rows (reference ConstructHistograms for
    the smaller leaf, serial_tree_learner.cpp:333): gather the bin rows
    and the ordered grad/hess by the leaf's index range, then
    ``histogram``. The gather is plain PyTorch glue."""
    rows, valid = gather_leaf_rows(perm, start, count, capacity)
    b = bins_full[rows]
    g = torch.where(valid, grad[rows], 0)     # keeps int32 levels int32
    h = torch.where(valid, hess[rows], 0)
    return histogram(b, g, h, num_bins, method=method)


# ---------------------------------------------------------------------------
# layout and precision dispatch
# ---------------------------------------------------------------------------

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


def _note_layout(layout: str, occ) -> None:
    """Telemetry: which layout the dispatcher picked, and the measured
    occupancy behind the decision (obs schema minor 10)."""
    from .. import obs
    obs.inc(f"hist.layout_{layout}")
    if occ is not None:
        obs.set_gauge("hist.row_nnz_mean", float(occ.row_nnz_mean))


def hist_method(config, dataset=None) -> Optional[str]:
    """The ONE histogram dispatch of the learners, named as in the JAX
    package. On the card: "multival_pallas" when ``hist_layout`` picks
    the row-wise multi-value layout for this dataset (wide-sparse
    shapes), else the planar / row-major kernels in ``tpu_hist_dtype``
    ("radix_pallas_bf16" by default, "radix_pallas" for float32). On the
    CPU: None — the exact float32 plain path, the rule the JAX package
    applies off-TPU, so the CPU gate compares like with like."""
    if config.device_type == "cpu":
        return None
    occ = getattr(dataset, "occupancy", None) if dataset is not None \
        else None
    if hist_layout(config, dataset) == "multival" and occ is not None:
        _note_layout("multival", occ)
        return "multival_pallas"
    _note_layout("planar", occ)
    return ("radix_pallas" if config.tpu_hist_dtype == "float32"
            else "radix_pallas_bf16")


def hist_dtype(method: Optional[str], config) -> torch.dtype:
    """Input precision of the histogram kernels for a ``hist_method``
    result: the multival kernels read ``tpu_hist_dtype`` directly, as in
    the JAX package; on the CPU it is float32 whatever the method (the
    JAX package's CPU paths are its exact float32 oracles)."""
    if config.device_type == "cpu":
        return torch.float32
    if method == "radix_pallas_bf16" or (
            method == "multival_pallas"
            and config.tpu_hist_dtype == "bfloat16"):
        return torch.bfloat16
    return torch.float32
