"""Planar training-row layout and the stable window partition.

The port of the JAX package's ops/plane.py. The training state is ONE
``[P, R]`` int32 tensor, lane-major (row r = lane r): bin-code planes
(4, 8 or 16-bit codes packed little-endian into int32 words), then
grad / hess / row-id / label / score / weight planes as f32 or i32 bit
patterns. The layout is byte-identical to the JAX package's, so the
same state can be fed to both.

Unlike the JAX package, which keeps the state immutable and donates it,
the port updates the state IN PLACE: ``partition`` permutes the
window's lanes in the given tensor, and ``set_f32`` / ``set_gh`` write
planes of it.

DataPartition::Split (reference data_partition.hpp:72) is
``partition``: ``partition_cuda`` (the hand-written CUDA kernel in
csrc/partition.cu) for a tensor on the card, or its plain PyTorch
version (``partition_plain``, a stable argsort of the window) for a
tensor on the CPU. ``partition_dev`` is the same partition of a window
that lives on the device ([2] int32 start, count): the kernel reads it
and chooses its route there, its launches sized by a bound the caller
holds, so nothing is read back and a CUDA graph can replay it. The
routing decision per lane is ``route_from_col32``.

The wide-sparse layout adds ``mv_planes`` slot planes of row-wise flat
codes (ops/multival.py) after the scalar planes; the partition moves
them with every other plane, so they stay row-aligned.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence, Union

import torch

from . import cuda as K

DEF_TILE = 4096
# ceiling of the lane-padding tile: R carries one max_tile of window
# headroom, exactly as in the JAX package, so layouts stay identical
MAX_TILE = 32768

ROUTE_SCALARS = 19      # routing vector length (see route_scalars)
CAT_WORDS = 8           # bitset words -> categorical bins <= 256

# csrc/partition.cu: lanes per tile of its large-window route (kTile,
# lgbt_partition_tile) and the shared-memory bytes of its one-block
# small-window route (kSmallBytes; see partition_small)
PART_TILE = 2048
PART_SMALL_BYTES = 200 * 1024


class PlaneLayout(NamedTuple):
    """Plane indices of the [P, R] int32 training-state tensor."""
    num_cols: int        # G bundle columns
    code_bits: int       # bits per bin code (4, 8 or 16)
    code_planes: int     # ceil(G*bits / 32)
    grad: int
    hess: int
    rowid: int
    label: int           # -1 when absent
    score: int           # -1 when absent
    weight: int          # -1 when absent
    num_planes: int      # P, padded to a multiple of 8
    num_rows: int        # true row count n
    num_lanes: int       # R, n padded to a multiple of max_tile
                         # (+ 1 max_tile of window headroom)
    tile: int
    max_tile: int
    mv_start: int = -1   # first multi-value slot plane (8-aligned), -1
                         # when absent
    mv_planes: int = 0   # slot planes (row capacity, a multiple of 8)


def make_layout(num_cols: int, code_bits: int, n: int,
                with_label: bool = False, with_score: bool = False,
                with_weight: bool = False, tile: int = DEF_TILE,
                mv_planes: int = 0) -> PlaneLayout:
    if code_bits not in (4, 8, 16) or mv_planes % 8:
        raise ValueError(f"code_bits {code_bits} / mv_planes {mv_planes}")
    cp = -(-num_cols * code_bits // 32)
    p = cp
    if p % 8 == 7:
        # grad % 8 <= 6: keeps the layout identical to the JAX package's
        # (its TPU histogram reads grad+hess as one aligned 8-plane block)
        p += 1
    grad, hess = p, p + 1
    p += 2
    rowid = p
    p += 1
    label = score = weight = -1
    if with_label:
        label = p
        p += 1
    if with_score:
        score = p
        p += 1
    if with_weight:
        weight = p
        p += 1
    mv_start = -1
    if mv_planes:
        # slot planes start 8-aligned, as in the JAX package (its
        # multival kernel reads them as (8, Rb) tile-aligned blocks)
        p = -(-p // 8) * 8
        mv_start = p
        p += mv_planes
    num_planes = -(-p // 8) * 8
    max_tile = tile
    while max_tile * 2 <= min(MAX_TILE, max(tile, n // 8)):
        max_tile *= 2
    num_lanes = (-(-n // max_tile) + 1) * max_tile
    return PlaneLayout(num_cols, code_bits, cp, grad, hess, rowid,
                       label, score, weight, num_planes, n, num_lanes,
                       tile, max_tile, mv_start, mv_planes)


def f32_as_i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def i32_as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous().view(torch.float32)


def _pack_codes(codes: torch.Tensor, layout: PlaneLayout,
                lanes: int) -> torch.Tensor:
    """[n, G] bin codes -> [code_planes, lanes] int32 (little-endian
    packing: column j occupies bits [j*bits % 32, ...) of plane
    j*bits // 32; 4-bit mode packs two columns per byte)."""
    n, g = codes.shape
    bits = layout.code_bits
    c = codes.to(torch.int32)
    if bits == 4:
        if g % 2:
            c = torch.nn.functional.pad(c, (0, 1))
        b = (c[:, 0::2] & 15) | ((c[:, 1::2] & 15) << 4)
    elif bits == 8:
        b = c & 255
    else:
        b = torch.stack([c & 255, (c >> 8) & 255], dim=2).reshape(n, 2 * g)
    width = layout.code_planes * 4
    b = torch.nn.functional.pad(b, (0, width - b.shape[1], 0, lanes - n))
    planes = b.to(torch.uint8).contiguous().view(torch.int32)  # [lanes, C]
    return planes.t().contiguous()


def build_codes_planes(codes: torch.Tensor, layout: PlaneLayout
                       ) -> torch.Tensor:
    """[n, G] bin codes -> [code_planes, R] int32."""
    return _pack_codes(codes, layout, layout.num_lanes)


def build_data(layout: PlaneLayout, codes_planes: torch.Tensor,
               grad: torch.Tensor, hess: torch.Tensor,
               rowid: Optional[torch.Tensor] = None,
               label: Optional[torch.Tensor] = None,
               score: Optional[torch.Tensor] = None,
               weight: Optional[torch.Tensor] = None,
               mv: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble the [P, R] planar state on the device of
    ``codes_planes``. grad/hess/... are [n] f32 in lane order. ``mv``:
    [mv_planes, n] int32 slot-major row-wise codes when the layout
    reserves slot planes; pad lanes get the -1 no-contribution code.
    ``out``: a [P, R] int32 tensor on that device to build the state
    into (cleared first) instead of a new one, so that a state rebuilt
    per tree keeps one address."""
    R = layout.num_lanes
    dev = codes_planes.device
    n = grad.shape[0]
    if out is None:
        data = torch.zeros((layout.num_planes, R), dtype=torch.int32,
                           device=dev)
    else:
        if (out.shape != (layout.num_planes, R) or out.dtype != torch.int32
                or out.device != dev or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous [{layout.num_planes}"
                             f", {R}] int32 tensor on {dev}")
        data = out.zero_()
    data[:layout.code_planes] = codes_planes
    set_gh(data, layout, grad.to(dev), hess.to(dev))
    if rowid is None:
        rowid = torch.arange(n, dtype=torch.int32, device=dev)
    data[layout.rowid, :rowid.shape[0]] = rowid.to(dev, torch.int32)
    # pad lanes get row ids CONTINUING past the real rows (never 0), as
    # in the JAX package
    data[layout.rowid, rowid.shape[0]:] = torch.arange(
        rowid.shape[0], R, dtype=torch.int32, device=dev)
    for idx, val in ((layout.label, label), (layout.score, score),
                     (layout.weight, weight)):
        if idx >= 0 and val is not None:
            set_f32(data, idx, val.to(dev))
    if layout.mv_planes:
        if mv is None or mv.shape[0] != layout.mv_planes:
            raise ValueError(f"layout needs {layout.mv_planes} slot planes")
        sl = slice(layout.mv_start, layout.mv_start + layout.mv_planes)
        data[sl] = -1
        data[sl, :mv.shape[1]] = mv.to(dev, torch.int32)
    return data


def get_f32(data: torch.Tensor, plane: int, n: Optional[int] = None
            ) -> torch.Tensor:
    """A float32 VIEW of one plane (writes through to ``data``)."""
    v = data[plane].view(torch.float32)
    return v if n is None else v[:n]


def set_f32(data: torch.Tensor, plane: int, values: torch.Tensor) -> None:
    """Write ``values`` (f32, length <= R) into a plane, in place."""
    v = f32_as_i32(values)
    data[plane, :v.shape[0]] = v


def set_gh(data: torch.Tensor, layout: PlaneLayout, grad: torch.Tensor,
           hess: torch.Tensor) -> None:
    """Write the gradient and hessian planes, in place."""
    set_f32(data, layout.grad, grad)
    set_f32(data, layout.hess, hess)


def set_gh_packed(data: torch.Tensor, layout: PlaneLayout,
                  packed_f32: torch.Tensor) -> None:
    """Write a quantize-packed (qg << 16 | qh) word plane, bitcast
    through float32, into the gradient plane and zero the hessian plane,
    in place: the quantized kernels unpack both levels from the one
    word."""
    v = f32_as_i32(packed_f32)
    data[layout.grad, :v.shape[0]] = v
    data[layout.grad, v.shape[0]:] = 0
    data[layout.hess] = 0


# ---------------------------------------------------------------------------
# routing scalars
# ---------------------------------------------------------------------------

Scalar = Union[int, bool, torch.Tensor]


def route_scalars(layout: PlaneLayout, feature: Scalar, threshold: Scalar,
                  default_left: Scalar, miss_bin: Scalar, efb_dev=None,
                  is_cat: Optional[Scalar] = None,
                  cat_bitset: Optional[Union[Sequence[int],
                                             torch.Tensor]] = None,
                  device=None) -> torch.Tensor:
    """[19] int32 routing vector of one split, on ``device`` (default:
    the device of a tensor argument, else the CPU). Layout:
    [plane, shift, mask, thr, dl, miss, efb_use, efb_off, efb_nsl,
     efb_skip, is_cat, bitset_w0..w7]. Scalars may be host ints or 0-d
    device tensors; device tensors never leave the device."""
    if device is None:
        device = next((a.device for a in (feature, threshold, default_left,
                                          miss_bin) if torch.is_tensor(a)),
                      torch.device("cpu"))

    def t(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.int32).reshape(())
        return torch.full((), int(x), dtype=torch.int32, device=device)

    feature = t(feature)
    bits = layout.code_bits
    if efb_dev is not None:
        # gathers: indexing by the 0-d device tensor would read it back
        group_of, offset_of, nslots_of, skip_of = efb_dev
        fi = feature.reshape(1).to(group_of.device)
        gidx, off, nsl, skip = (tab.index_select(0, fi)[0] for tab in
                                (group_of, offset_of, nslots_of, skip_of))
        efb = [t(1), off, nsl, skip]
    else:
        gidx = feature
        efb = [t(0), t(0), t(0), t(0)]
    bitpos = gidx * bits
    head = torch.stack([t(bitpos // 32), t(bitpos % 32), t((1 << bits) - 1),
                        t(threshold), t(default_left), t(miss_bin),
                        *[t(e) for e in efb],
                        t(0 if is_cat is None else is_cat)])
    words = torch.zeros(CAT_WORDS, dtype=torch.int32, device=device)
    if cat_bitset is not None:
        cb = torch.as_tensor(cat_bitset).to(device=device, dtype=torch.int32)
        words[:cb.shape[0]] = cb
    return torch.cat([head, words])


def route_from_col32(col32: torch.Tensor, rs: Sequence[int]) -> torch.Tensor:
    """Shared routing math (JAX plane.py _route_from_col32): packed
    plane words [W] int32 -> go_left [W] bool, for the routing vector
    ``rs`` given as host ints. Shifts are logical: the words are widened
    to int64 and masked to their unsigned 32-bit value first."""
    u = col32.to(torch.int64) & 0xFFFFFFFF
    code = (u >> rs[1]) & rs[2]
    rel = code - rs[7]
    inband = (rel >= 0) & (rel < rs[8])
    dec = rel + (rel >= rs[9]).to(torch.int64)
    efb_bin = torch.where(inband, dec, torch.full_like(dec, rs[9]))
    binval = efb_bin if rs[6] == 1 else code
    if rs[10] == 1:
        words = torch.tensor([w & 0xFFFFFFFF for w in rs[11:11 + CAT_WORDS]]
                             + [0], dtype=torch.int64, device=col32.device)
        widx = torch.clamp(binval >> 5, max=CAT_WORDS)
        return ((words[widx] >> (binval & 31)) & 1) == 1
    go_left = binval <= rs[3]
    if rs[5] >= 0:
        go_left = torch.where(binval == rs[5], bool(rs[4]), go_left)
    return go_left


# ---------------------------------------------------------------------------
# the partition: plain version + CUDA kernel wrapper
# ---------------------------------------------------------------------------

def partition_plain(data: torch.Tensor, layout: PlaneLayout, start,
                    count, rscal: torch.Tensor):
    """Stable window partition in plain PyTorch (the port's oracle):
    the stable argsort of the JAX package's partition_ref over the
    dynamic window [start, start+count). ``start``/``count``: host ints,
    or tensors that it reads (a window given as one [2] tensor passes
    ``count=None``). Updates ``data`` in place and returns (data,
    nleft) with nleft a 0-d int32 tensor."""
    if count is None:
        start, count = (int(v) for v in start.tolist())
    start, count = int(start), int(count)
    rs = [int(v) for v in rscal.tolist()]
    win = data[:, start:start + count]
    go_left = route_from_col32(win[rs[0]], rs)
    order = torch.argsort((~go_left).to(torch.int32), stable=True)
    data[:, start:start + count] = win[:, order]
    return data, go_left.sum().to(torch.int32)


def partition_small(num_planes: int, count: int) -> bool:
    """True when a window of ``count`` lanes of a ``num_planes``-plane
    state takes the partition kernel's one-block route: every plane
    word of the window and one rank per lane, ``(P + 1) * count * 4``
    bytes, fit in PART_SMALL_BYTES of one block's shared memory (about
    3,000 lanes at P = 16, 400 at P = 128). Equal to the CUDA kernel's
    ``lgbt_partition_small``."""
    return count * (num_planes + 1) * 4 <= PART_SMALL_BYTES


# per (device, stream), for the life of the process like the loaded
# kernel libraries: the large route's status words (csrc/partition.cu
# lgbt_partition; word 0 keeps the ticket and the epoch on the device)
_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()


def _status_words(dev, stream: int, words: int):
    """The status buffer of ``stream`` holding at least ``words`` uint64
    words. The buffer is zeroed once when it is made (or grown); the
    kernel advances the epoch in its word 0 at every launch, so no call
    needs a memset."""
    key = (dev, stream)
    with _STATUS_LOCK:
        buf = _STATUS.get(key)
        if buf is None or buf.numel() < words:
            n = words if buf is None else max(words, 2 * buf.numel())
            buf = torch.zeros(n, dtype=torch.int64, device=dev)
        _STATUS[key] = buf
        return buf


def dev_status_words(num_planes: int, bound: int) -> int:
    """The uint64 status words of ``partition_dev`` for windows of at
    most ``bound`` lanes (csrc/partition.cu
    lgbt_partition_dev_status_words): 0 when every such window takes the
    one-block route, else word 0 plus the most (tile, plane group) words
    any count up to the bound uses."""
    if partition_small(num_planes, bound):
        return 0
    most = 1
    for t in range(1, -(-bound // PART_TILE) + 1):
        want = min(max(-(-264 // t), 1), -(-num_planes // 8))
        pg = -(-num_planes // want)
        most = max(most, t * -(-num_planes // pg))
    return 1 + most


class PartitionBuffers:
    """The scratch and status words of ``partition_dev`` on one stream,
    made once for windows of at most ``bound`` lanes (a learner holds
    one): [P * bound] int32 scratch and zeroed status words, both None
    when every window up to the bound takes the one-block route."""

    def __init__(self, num_planes: int, bound: int, device) -> None:
        self.bound = int(bound)
        self.num_planes = int(num_planes)
        words = dev_status_words(num_planes, bound)
        self.scratch = self.status = None
        if words:
            self.scratch = torch.empty(num_planes * self.bound,
                                       dtype=torch.int32, device=device)
            self.status = torch.zeros(words, dtype=torch.int64,
                                      device=device)


def partition_cuda(data: torch.Tensor, layout: PlaneLayout, start: int,
                   count: int, rscal: torch.Tensor, cat: bool = False):
    """Stable in-place partition of the lane window [start, start+count)
    of ALL P planes by the split in ``rscal`` (route_scalars), by the
    CUDA kernel csrc/partition.cu (the counterpart of the JAX package's
    partition_pallas2 and partition_pallas): lefts first, then rights,
    order kept on both sides, lanes outside the window untouched.
    Returns (data, nleft); ``data`` is the SAME tensor updated in place
    and nleft a 0-d int32 tensor on its device. A small window
    (``partition_small``) is one launch with no scratch; a large one
    takes a [P, count] scratch and the stream's status words. Raises
    for a state that is not on the card. ``cat``: the caller's host copy
    of the routing vector's is_cat flag; a launch on the categorical
    (bitset) route also counts under ``partition_cat``."""
    start, count = int(start), int(count)
    P, R = data.shape
    if not 0 <= start <= start + count <= R:
        raise ValueError(f"window [{start}, {start + count}) outside [0, {R})")
    if not data.is_cuda:
        raise ValueError("partition_cuda launches a CUDA kernel: the state "
                         "must be on the card (partition takes the plain "
                         "version on the CPU)")
    if data.dtype != torch.int32 or not data.is_contiguous():
        raise ValueError("partition_cuda needs a contiguous int32 state")
    if (rscal.device != data.device or rscal.dtype != torch.int32
            or rscal.shape != (ROUTE_SCALARS,) or not rscal.is_contiguous()):
        raise ValueError("rscal must be a contiguous [19] int32 tensor on "
                         "the state's device")
    lib = K.lib("partition")
    small = partition_small(P, count)
    if bool(lib.lgbt_partition_small(P, count)) != small:
        raise RuntimeError(f"partition_cuda: the kernel's small-window rule "
                           f"for P={P}, count={count} is not "
                           f"partition_small's {small}")
    dev = data.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    nleft = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = status = None
    if not small:
        scratch = torch.empty(P * count, dtype=torch.int32, device=dev)
        status = _status_words(dev, stream,
                               lib.lgbt_partition_status_words(P, count))
    K.check(lib.lgbt_partition(
        data.data_ptr(), R, P, start, count, rscal.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if status is None else status.data_ptr(),
        nleft.data_ptr(), stream), "partition_cuda")
    K.LAUNCHES["partition"] += 1
    if cat:
        K.LAUNCHES["partition_cat"] += 1
    return data, nleft[0]


def _check_win(data, win, rscal, bound: int) -> None:
    P, R = data.shape
    if not (torch.is_tensor(win) and win.dtype == torch.int32
            and win.shape == (2,) and win.device == data.device):
        raise ValueError("the window must be a [2] int32 tensor (start, "
                         "count) on the state's device")
    if not 0 <= bound <= R:
        raise ValueError(f"bound {bound} outside [0, {R}]")
    if (rscal.device != data.device or rscal.dtype != torch.int32
            or rscal.shape != (ROUTE_SCALARS,) or not rscal.is_contiguous()):
        raise ValueError("rscal must be a contiguous [19] int32 tensor on "
                         "the state's device")


def partition_dev_cuda(data: torch.Tensor, layout: PlaneLayout,
                       win: torch.Tensor, rscal: torch.Tensor,
                       bufs: PartitionBuffers,
                       cat_count: Optional[torch.Tensor] = None):
    """``partition_cuda`` of a window on the card: ``win`` is a [2]
    int32 tensor (start, count) that the kernel reads, count <=
    ``bufs.bound`` (the caller's bound; it sizes every launch). The
    route (one block or tiles) is chosen on the device. No host read,
    no allocation but nleft's, so the call can be captured in a CUDA
    graph. ``cat_count``: a device counter that gains the routing
    vector's is_cat flag (the categorical route's launches). Returns
    (data, nleft) as ``partition_cuda``."""
    P, R = data.shape
    if not data.is_cuda:
        raise ValueError("partition_dev_cuda launches a CUDA kernel: the "
                         "state must be on the card")
    if data.dtype != torch.int32 or not data.is_contiguous():
        raise ValueError("partition_dev_cuda needs a contiguous int32 state")
    _check_win(data, win, rscal, bufs.bound)
    if bufs.num_planes != P:
        raise ValueError(f"buffers for P={bufs.num_planes}, state has {P}")
    lib = K.lib("partition")
    words = lib.lgbt_partition_dev_status_words(P, bufs.bound)
    have = 0 if bufs.status is None else bufs.status.numel()
    if words != have:
        raise RuntimeError(f"partition_dev_cuda: the kernel needs {words} "
                           f"status words for P={P}, bound={bufs.bound}; "
                           f"dev_status_words gave {have}")
    dev = data.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    nleft = torch.empty(1, dtype=torch.int32, device=dev)
    win = win.contiguous()
    K.check(lib.lgbt_partition_dev(
        data.data_ptr(), R, P, win.data_ptr(), bufs.bound, rscal.data_ptr(),
        None if bufs.scratch is None else bufs.scratch.data_ptr(),
        None if bufs.status is None else bufs.status.data_ptr(),
        nleft.data_ptr(), stream), "partition_dev_cuda")
    K.LAUNCHES["partition"] += 1
    if cat_count is not None:
        cat_count.add_(rscal[10:11].to(torch.int64))
    return data, nleft[0]


def partition_dev(data: torch.Tensor, layout: PlaneLayout,
                  win: torch.Tensor, rscal: torch.Tensor,
                  bufs: PartitionBuffers,
                  cat_count: Optional[torch.Tensor] = None):
    """The stable window partition of a window held on the device:
    ``partition_dev_cuda`` for a state on the card, ``partition_plain``
    on the CPU (which reads the window: no sync there)."""
    if data.is_cuda:
        return partition_dev_cuda(data, layout, win, rscal, bufs, cat_count)
    _check_win(data, win, rscal, bufs.bound)
    start, count = (int(v) for v in win.tolist())
    if not 0 <= start <= start + count <= data.shape[1] \
            or count > bufs.bound:
        raise ValueError(f"window [{start}, {start + count}) outside "
                         f"[0, {data.shape[1]}) or beyond the bound "
                         f"{bufs.bound}")
    return partition_plain(data, layout, start, count, rscal)


def partition(data: torch.Tensor, layout: PlaneLayout, start: int,
              count: int, rscal: torch.Tensor, cat: bool = False):
    """The stable window partition: ``partition_cuda`` for a state on
    the card, ``partition_plain`` for a state on the CPU."""
    if data.is_cuda:
        return partition_cuda(data, layout, start, count, rscal, cat)
    start, count = int(start), int(count)
    if not 0 <= start <= start + count <= data.shape[1]:
        raise ValueError(f"window [{start}, {start + count}) outside "
                         f"[0, {data.shape[1]})")
    return partition_plain(data, layout, start, count, rscal)


def partition_window(data, layout, start, count, rscal):
    """The JAX package's entry point: both of its kernel generations
    (partition_pallas2 and partition_pallas) are backed by ONE CUDA
    kernel, so this is ``partition``."""
    return partition(data, layout, start, count, rscal)
