"""Row-wise multi-value histograms: the wide-sparse layout.

The port of the JAX package's ops/multival.py (the reference MultiValBin
analogue, src/io/multi_val_dense_bin.hpp). At the wide-sparse shape
(Allstate/Criteo: many EFB bundles, a handful present per row) each row
stores only its PRESENT (group, bin) entries, and the histogram pass
touches those alone.

Layout (built once from the [N, G] bin matrix):
  - flat code space: group g's bin b maps to ``flat_off[g] + b``, with
    ``T = sum(group_num_bins)`` cells;
  - per group a DEFAULT code (its sampled most-frequent code); an entry
    is present iff it differs from it, and the default cell is rebuilt
    from the leaf totals (``group_hist_from_flat``);
  - each row packs its present flat codes into K int32 slots; slot 0
    carries the SENTINEL code T, so cell T of the flat histogram holds
    the leaf totals; unused slots hold -1 and add nothing.

Kernels, each as ``*_plain`` (plain PyTorch), ``*_cuda`` (the CUDA
kernel in csrc/hist_multival.cu, raising for tensors off the card) and a
dispatcher chosen by the tensor's device:

- ``hist_multival_planar``: the fused learner's leaf histogram over the
  slot planes of the planar state (the JAX package's
  histogram_multival_planar);
- ``hist_multival``: the serial learner's histogram over slot-major
  codes and [8, C] grad/hess lane planes (the JAX package's
  histogram_multival_pallas).

``histogram_multival_scatter`` is the one-pass oracle (the JAX package's
histogram_multival_xla). Both kernels have a quantized mode
(``quant=True``): one packed ``(qg << 16) | qh`` word per row in the grad
plane / lane row 0, summed exactly into a [T+1, 2] int32 histogram; its
plain version is one ``index_add_`` in int32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cuda as K
from .histogram import (_check_dtype, _need_cuda, _window_args,
                        gather_leaf_rows)
from .quantize import pack_gh, unpack_gh
from .split import xla_sum

MV_SK = 8            # slot-plane tile: slot counts are padded to it
# rows per warp tile of the CUDA kernels (csrc/hist_multival.cu kTile);
# the plain versions sum in the same association
MV_TILE = 512

# layout decision thresholds (ops/histogram.py hist_layout): the
# multi-value layout needs at least this many groups, and a mean
# present-codes-per-row of at most this fraction of the group count
MULTIVAL_MIN_GROUPS = 32
MULTIVAL_MAX_OCCUPANCY = 0.25


class OccupancyStats(NamedTuple):
    """Measured dataset occupancy (io/dataset.py computes this at
    construct time from a bounded deterministic row sample)."""
    num_groups: int
    row_nnz_mean: float          # mean non-default codes per row
    row_nnz_max: int             # max over the sample
    default_code: np.ndarray     # [G] int32 per-group default code
    group_density: np.ndarray    # [G] f32 non-default fraction
    sample_rows: int


class MultiValLayout(NamedTuple):
    """Static geometry of one dataset's row-wise code matrix."""
    num_groups: int
    total_bins: int              # T; sentinel code == T
    row_capacity: int            # K slots/row incl. the sentinel slot 0
    num_rows: int
    nnz_max: int                 # exact full-data max present codes/row


def measure_occupancy(bins: np.ndarray, sample_rows: int = 65536
                      ) -> OccupancyStats:
    """Occupancy statistics from a deterministic strided row sample of
    the [N, G] bin-code matrix. The per-group default code is the
    sample's most frequent code (for multi-feature EFB bundles that is
    code 0 by construction; for singleton groups it is the feature's
    most-frequent bin)."""
    n, g = bins.shape
    step = max(1, n // max(1, sample_rows))
    sample = np.asarray(bins[::step][:sample_rows])
    default = np.empty(g, np.int32)
    for j in range(g):
        default[j] = np.argmax(np.bincount(sample[:, j]))
    present = sample != default[None, :]
    nnz = present.sum(axis=1)
    return OccupancyStats(
        num_groups=int(g),
        row_nnz_mean=float(nnz.mean()) if nnz.size else 0.0,
        row_nnz_max=int(nnz.max()) if nnz.size else 0,
        default_code=default,
        group_density=present.mean(axis=0).astype(np.float32),
        sample_rows=int(sample.shape[0]))


def bucket_row_capacity(nnz_max: int) -> int:
    """Static slot capacity K for a measured per-row nnz max: the +1
    sentinel slot, rounded up a coarse ladder (multiples of 8 to 64,
    then quarter-power-of-two steps)."""
    k = int(nnz_max) + 1
    if k <= 8:
        return 8
    if k <= 64:
        return -(-k // 8) * 8
    step = max(8, (1 << (int(k - 1).bit_length() - 1)) // 4)
    return -(-k // step) * step


def flat_offsets(group_num_bins) -> np.ndarray:
    """[G] int64 start of each group's cells in the flat code space."""
    nb = np.asarray(group_num_bins, np.int64)
    return np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int64)


def build_rowwise_codes(bins: np.ndarray, group_num_bins, default_code,
                        row_capacity: Optional[int] = None,
                        row_chunk: int = 1 << 18
                        ) -> Tuple[np.ndarray, MultiValLayout]:
    """[N, G] bin codes -> ([N, K] int32 row-wise flat codes, layout).

    Chunked over rows so the transient present-mask stays bounded. The
    exact full-data nnz max comes from a first full pass: a sampled max
    could truncate a heavy row's code list."""
    n, g = bins.shape
    default = np.asarray(default_code, bins.dtype)
    off = flat_offsets(group_num_bins)
    total = int(np.asarray(group_num_bins, np.int64).sum())

    nnz_max = 0
    for lo in range(0, n, row_chunk):
        chunk = np.asarray(bins[lo:lo + row_chunk])
        cnt = (chunk != default[None, :]).sum(axis=1)
        if cnt.size:
            nnz_max = max(nnz_max, int(cnt.max()))
    k = row_capacity if row_capacity is not None \
        else bucket_row_capacity(nnz_max)
    if nnz_max + 1 > k:
        raise ValueError(f"row capacity {k} < measured nnz max "
                         f"{nnz_max} + sentinel")

    codes = np.full((n, k), -1, np.int32)
    codes[:, 0] = total                      # sentinel -> leaf totals
    for lo in range(0, n, row_chunk):
        chunk = np.asarray(bins[lo:lo + row_chunk])
        mask = chunk != default[None, :]
        rows, gs = np.nonzero(mask)          # group-ascending per row
        cnt = mask.sum(axis=1)
        starts = np.cumsum(cnt) - cnt
        pos = np.arange(rows.size) - starts[rows]
        codes[lo + rows, 1 + pos] = (off[gs]
                                     + chunk[rows, gs]).astype(np.int32)
    return codes, MultiValLayout(num_groups=int(g), total_bins=total,
                                 row_capacity=int(k), num_rows=int(n),
                                 nnz_max=int(nnz_max))


# ---------------------------------------------------------------------------
# flat histogram [T+1, 2] -> group histogram [G, Bg, 2]
# ---------------------------------------------------------------------------

def group_tables(group_num_bins, default_code, device="cpu"):
    """Gather tables mapping the flat histogram back to group space with
    each group's default cell rebuilt, as tensors on ``device``: (idx
    int64 [G, Bg], valid f32 [G, Bg], default one-hot f32 [G, Bg])."""
    nb = np.asarray(group_num_bins, np.int64)
    bg = int(nb.max()) if len(nb) else 1
    off = flat_offsets(nb)
    d = np.asarray(default_code, np.int64)
    b_iota = np.arange(bg)[None, :]
    inband = b_iota < nb[:, None]
    is_def = inband & (b_iota == d[:, None])
    idx = np.where(inband & ~is_def, off[:, None] + b_iota, 0)
    return (torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor((inband & ~is_def).astype(np.float32),
                            device=device),
            torch.as_tensor(is_def.astype(np.float32), device=device))


def group_hist_from_flat(flat: torch.Tensor, tables) -> torch.Tensor:
    """[T+1, 2] flat histogram -> [G, Bg, 2]: cell T carries the leaf
    (sum_g, sum_h) totals (the sentinel slot), and each group's default
    cell is total - sum(its other cells). Keeps the flat histogram's
    dtype: exact in int32 for quantized levels. The float32 sum over a
    group's cells runs in XLA's reduce order (``xla_sum``), which the
    JAX package's learners take, so the rebuilt default cell has their
    bits."""
    idx, valid, dmask = tables
    gh = flat[idx] * valid[..., None].to(flat.dtype)
    total = flat[-1]                                    # [2]
    if gh.dtype == torch.float32:
        other = xla_sum(gh.transpose(1, 2))
    else:
        other = gh.sum(dim=1).to(flat.dtype)
    fill = total[None, :] - other
    return gh + dmask[..., None].to(flat.dtype) * fill[:, None, :]


# ---------------------------------------------------------------------------
# the oracle and the plain versions
# ---------------------------------------------------------------------------

def histogram_multival_scatter(codes: torch.Tensor, grad: torch.Tensor,
                               hess: torch.Tensor, total_bins: int
                               ) -> torch.Tensor:
    """Row-wise flat histogram by one scatter-add (the JAX package's
    histogram_multival_xla, the oracle): codes [C, K] int32 (-1 = pad),
    grad/hess [C] f32, or int32 levels (exact int32 sums) -> [T+1, 2]
    (cell T = leaf totals). Codes outside [0, T] add nothing."""
    flat = codes.reshape(-1).to(torch.int64)
    live = (flat >= 0) & (flat <= total_bins)
    k = codes.shape[1]
    acc = torch.float32 if grad.is_floating_point() else torch.int32
    vals = torch.stack([grad, hess], dim=-1).to(acc)
    vals = vals[:, None, :].expand(-1, k, 2).reshape(-1, 2)
    vals = torch.where(live[:, None], vals, 0)
    out = torch.zeros((total_bins + 1, 2), dtype=acc, device=codes.device)
    out.index_add_(0, torch.where(live, flat, 0), vals)
    return out


def _tiled_flat(codes_sm: torch.Tensor, grad: torch.Tensor,
                hess: torch.Tensor, total_bins: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Flat histogram of slot-major codes [Kp, C] in the CUDA kernels'
    association: per tile of MV_TILE rows each cell summed in row order,
    then the tiles added in order. Codes outside [0, T] add nothing."""
    kp, c = codes_sm.shape
    cells = total_bins + 1
    dev = codes_sm.device
    g, h = grad.to(torch.float32), hess.to(torch.float32)
    if dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).to(torch.float32)
        h = h.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((cells, 2), dtype=torch.float32, device=dev)
    if c == 0:
        return out
    ntiles = -(-c // MV_TILE)
    codes = codes_sm.t().to(torch.int64)                 # [C, Kp]
    ok = (codes >= 0) & (codes <= total_bins)
    tile_of = torch.arange(c, device=dev) // MV_TILE
    idx = tile_of[:, None] * cells + torch.where(ok, codes, 0)
    vals = torch.where(ok[..., None], torch.stack([g, h], -1)[:, None, :],
                       0.0)
    parts = torch.zeros((ntiles * cells, 2), dtype=torch.float32,
                        device=dev)
    parts.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    parts = parts.reshape(ntiles, cells, 2)
    for t in range(ntiles):
        out = out + parts[t]
    return out


def _flat_quant(codes_sm: torch.Tensor, words: torch.Tensor,
                total_bins: int) -> torch.Tensor:
    """Quantized flat histogram [T+1, 2] int32 of slot-major codes
    [Kp, C] and one packed level word per row: exact int32 sums."""
    qg, qh = unpack_gh(words)
    return histogram_multival_scatter(codes_sm.t(), qg, qh, total_bins)


def histogram_multival_plain(codes: torch.Tensor, gh: torch.Tensor, *,
                             total_bins: int,
                             dtype: torch.dtype = torch.float32,
                             quant: bool = False) -> torch.Tensor:
    """B6 in plain PyTorch: slot-major codes [Kp, C] and [8, C] lane
    planes (rows 0/1 = bitcast f32 grad/hess; row 0 = packed levels when
    ``quant``) -> [T+1, 2]."""
    if quant:
        return _flat_quant(codes, gh[0], total_bins)
    return _tiled_flat(codes, gh[0].view(torch.float32),
                       gh[1].view(torch.float32), total_bins, dtype)


def histogram_multival_planar_plain(data: torch.Tensor, start, count, *,
                                    mv_start: int, mv_planes: int,
                                    total_bins: int, grad_plane: int,
                                    dtype: torch.dtype = torch.float32,
                                    quant: bool = False) -> torch.Tensor:
    """B5 in plain PyTorch: the flat histogram of the lane window
    [start, start+count) over the slot planes of the planar state
    (packed levels in the grad plane when ``quant``)."""
    start, count = int(start), int(count)
    win = data[:, start:start + count]
    if quant:
        return _flat_quant(win[mv_start:mv_start + mv_planes],
                           win[grad_plane], total_bins)
    return _tiled_flat(win[mv_start:mv_start + mv_planes],
                       win[grad_plane].view(torch.float32),
                       win[grad_plane + 1].view(torch.float32),
                       total_bins, dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels and the dispatchers
# ---------------------------------------------------------------------------

def _mv_lib(slots: int, total_bins: int):
    lib = K.lib("hist_multival")
    if not 1 <= slots <= lib.lgbt_mv_max_slots() or total_bins < 0:
        raise ValueError(f"{slots} slots / total_bins {total_bins} out of "
                         "range for csrc/hist_multival.cu")
    return lib


def _mv_buffers(lib, max_count: int, total_bins: int, quant: bool, dev):
    """(partials, output) of one launch: the float modes sum per-tile
    partials of [T+1, 2] floats, one per MV_TILE rows of ``max_count``;
    the int32 mode adds straight into its output and takes no partials
    (None)."""
    if quant:
        return None, torch.empty((total_bins + 1, 2), dtype=torch.int32,
                                 device=dev)
    tiles = max(1, -(-max_count // lib.lgbt_mv_tile()))
    partials = torch.empty(tiles * (total_bins + 1) * 2,
                           dtype=torch.float32, device=dev)
    out = torch.empty((total_bins + 1, 2), dtype=torch.float32, device=dev)
    return partials, out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hist_multival_planar_cuda(data: torch.Tensor, start, count, *,
                              mv_start: int, mv_planes: int,
                              total_bins: int, grad_plane: int,
                              dtype: torch.dtype = torch.float32,
                              max_count: Optional[int] = None,
                              quant: bool = False) -> torch.Tensor:
    """[T+1, 2] float32 flat histogram of the lane window
    [start, start+count) of the planar state, by the CUDA kernel
    csrc/hist_multival.cu (entry lgbt_hist_multival_planar). The window
    is host ints or int32 scalars on the card (then ``max_count`` bounds
    the count and sizes the launch), as for ``hist_planar_cuda``.
    ``quant``: packed levels in the grad plane, int32 output."""
    _check_dtype(dtype)
    _need_cuda(data, "hist_multival_planar_cuda")
    if data.dtype != torch.int32 or data.dim() != 2 \
            or not data.is_contiguous():
        raise ValueError("needs a contiguous [P, R] int32 state")
    P, R = data.shape
    if mv_start < 0 or mv_start + mv_planes > P or grad_plane + 1 >= P:
        raise ValueError("slot / grad planes outside the state")
    dev = data.device
    sp, cp, sh, ch, max_count = _window_args(start, count, max_count, R, dev)
    lib = _mv_lib(mv_planes, total_bins)
    partials, out = _mv_buffers(lib, max_count, total_bins, quant, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K.check(lib.lgbt_hist_multival_planar(
        data.data_ptr(), R, sp, cp, sh, ch, max_count, mv_start, mv_planes,
        grad_plane, total_bins, int(dtype == torch.bfloat16), int(quant),
        _ptr(partials), out.data_ptr(), stream), "hist_multival_planar_cuda")
    K.LAUNCHES["hist_multival_planar_q" if quant
               else "hist_multival_planar"] += 1
    return out


def hist_multival_planar(data: torch.Tensor, start, count, *,
                         mv_start: int, mv_planes: int, total_bins: int,
                         grad_plane: int, dtype: torch.dtype = torch.float32,
                         max_count: Optional[int] = None,
                         quant: bool = False) -> torch.Tensor:
    """B5: the CUDA kernel for a state on the card, the plain version
    for a state on the CPU."""
    _check_dtype(dtype)
    kw = dict(mv_start=mv_start, mv_planes=mv_planes, total_bins=total_bins,
              grad_plane=grad_plane, dtype=dtype, quant=quant)
    if data.is_cuda:
        return hist_multival_planar_cuda(data, start, count,
                                         max_count=max_count, **kw)
    return histogram_multival_planar_plain(data, start, count, **kw)


def hist_multival_cuda(codes: torch.Tensor, gh: torch.Tensor, *,
                       total_bins: int, dtype: torch.dtype = torch.float32,
                       quant: bool = False) -> torch.Tensor:
    """[T+1, 2] float32 flat histogram of slot-major codes [Kp, C] int32
    and [8, C] int32 lane planes (rows 0/1 = bitcast f32 grad/hess,
    pre-masked), by the CUDA kernel csrc/hist_multival.cu (entry
    lgbt_hist_multival). ``quant``: row 0 holds packed levels, int32
    output."""
    _check_dtype(dtype)
    _need_cuda(codes, "hist_multival_cuda")
    kp, c = codes.shape
    if codes.dtype != torch.int32 or gh.dtype != torch.int32 \
            or gh.shape != (8, c) or gh.device != codes.device:
        raise ValueError("codes [Kp, C] and gh [8, C] must be int32 on the "
                         "same device")
    codes, gh = codes.contiguous(), gh.contiguous()
    dev = codes.device
    lib = _mv_lib(kp, total_bins)
    partials, out = _mv_buffers(lib, c, total_bins, quant, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K.check(lib.lgbt_hist_multival(
        codes.data_ptr(), gh.data_ptr(), kp, c, total_bins,
        int(dtype == torch.bfloat16), int(quant), _ptr(partials),
        out.data_ptr(), stream), "hist_multival_cuda")
    K.LAUNCHES["hist_multival_q" if quant else "hist_multival"] += 1
    return out


def hist_multival(codes: torch.Tensor, gh: torch.Tensor, *, total_bins: int,
                  dtype: torch.dtype = torch.float32,
                  quant: bool = False) -> torch.Tensor:
    """B6: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    _check_dtype(dtype)
    kw = dict(total_bins=total_bins, dtype=dtype, quant=quant)
    if codes.is_cuda:
        return hist_multival_cuda(codes, gh, **kw)
    return histogram_multival_plain(codes, gh, **kw)


# ---------------------------------------------------------------------------
# leaf-window entry for the serial learner (row-major codes + perm)
# ---------------------------------------------------------------------------

def slot_major(codes_window: torch.Tensor) -> torch.Tensor:
    """[C, K] row-major window -> [Kp, C] slot-major with the slot count
    padded to MV_SK (pad slots = -1)."""
    k = codes_window.shape[1]
    kp = -(-k // MV_SK) * MV_SK
    t = codes_window.t()
    if kp > k:
        t = torch.nn.functional.pad(t, (0, 0, 0, kp - k), value=-1)
    return t.contiguous()


def gh_planes(grad: torch.Tensor, hess: torch.Tensor,
              quant: bool = False) -> torch.Tensor:
    """Masked [C] grad/hess -> the [8, C] int32 lane planes the kernel
    reads: bitcast f32 rows 0/1, or one packed (qg << 16) | qh word row
    when ``quant`` (int32 levels); zeros elsewhere."""
    out = torch.zeros((8, grad.shape[0]), dtype=torch.int32,
                      device=grad.device)
    if quant:
        out[0] = pack_gh(grad, hess)
        return out
    out[0] = grad.to(torch.float32).contiguous().view(torch.int32)
    out[1] = hess.to(torch.float32).contiguous().view(torch.int32)
    return out


def leaf_histogram_multival(codes: torch.Tensor, perm: torch.Tensor, start,
                            count, grad: torch.Tensor, hess: torch.Tensor,
                            capacity: Optional[int], total_bins: int, *,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Row-wise flat histogram [T+1, 2] of a permuted leaf window (the
    ops/histogram.leaf_histogram twin for the multival layout). codes:
    [N, K] int32 row-wise flat codes; grad/hess [N] f32, or int32
    quantized levels (then the kernel's quantized mode, int32 output).
    The leaf's codes are gathered by ``perm`` and made slot-major in
    PyTorch (glue), then ``hist_multival`` runs."""
    rows, valid = gather_leaf_rows(perm, start, count, capacity)
    c = codes[rows]
    g = torch.where(valid, grad[rows], 0)     # keeps int32 levels int32
    h = torch.where(valid, hess[rows], 0)
    quant = not grad.is_floating_point()
    return hist_multival(slot_major(c), gh_planes(g, h, quant=quant),
                         total_bins=total_bins, dtype=dtype, quant=quant)
