"""Ranking objectives: LambdaRank-NDCG and XE-NDCG.

The port of the JAX package's ranking layer (reference
src/objective/rank_objective.hpp: RankingObjective :27-96,
LambdarankNDCG :98-286, RankXENDCG :288-360). As there, the queries are
bucketed by padded size (powers of two from 8) and each bucket is one
batched [Q, M, M] masked pairwise program in plain torch on the
learner's device, in place of the reference's loop over queries; the
reference's sigmoid lookup table is not needed.

The float32 bits are those of the JAX package's jitted CPU program for
one bucket (``_chunk_lambdas``), site by site (ROADMAP §C): XLA's
inlined ``exp`` and ``log`` (``ops/xla_float.py``), its multiply-adds,
and the order in which it sums the pair terms of each document
(``_pair_sums``). The draws of ``rank_xendcg`` come from
``np.random.RandomState(objective_seed)`` in the JAX package's order:
one ``rand(Q, M)`` per chunk per iteration, chunks in bucket order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.xla_float import _log_f32, exp_f32, f32_value, fma_f32
from ..utils import log
from .functions import ObjectiveFunction

K_MAX_POSITION = 10000


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 gains (reference DCGCalculator::DefaultLabelGain)."""
    return (np.power(2.0, np.arange(max_label)) - 1.0)


class DCGCalculator:
    """reference include/LightGBM/metric.h:63 + src/metric/dcg_calculator.cpp
    (host float64)."""

    def __init__(self, label_gain: Optional[List[float]] = None) -> None:
        if label_gain:
            self.label_gain = np.asarray(label_gain, dtype=np.float64)
        else:
            self.label_gain = default_label_gain()
        self.discount = 1.0 / np.log2(np.arange(K_MAX_POSITION) + 2.0)

    def cal_max_dcg_at_k(self, k: int, labels: np.ndarray) -> float:
        labels = np.asarray(labels)
        srt = np.sort(labels)[::-1]
        k = min(k, len(srt))
        gains = self.label_gain[srt[:k].astype(np.int64)]
        return float(np.sum(gains * self.discount[:k]))

    def cal_dcg_at_k(self, k: int, labels: np.ndarray,
                     scores: np.ndarray) -> float:
        order = np.argsort(-scores, kind="stable")
        k = min(k, len(labels))
        lab = np.asarray(labels)[order[:k]].astype(np.int64)
        return float(np.sum(self.label_gain[lab] * self.discount[:k]))

    def check_label(self, labels: np.ndarray) -> None:
        if np.any(labels < 0) or np.any(labels >= len(self.label_gain)):
            log.fatal("Label excel(%d) in ranking cannot be handled; "
                      "set label_gain", int(np.max(labels)))


def _bucket_queries(boundaries: np.ndarray, min_size: int = 8,
                    max_rows_per_chunk: int = 1 << 22):
    """Group queries into padded-size buckets; big buckets are further
    chunked so the [Q, M, M] pairwise tensor stays bounded."""
    sizes = np.diff(boundaries)
    buckets: Dict[int, List[int]] = {}
    for qi, sz in enumerate(sizes):
        m = min_size
        while m < sz:
            m *= 2
        buckets.setdefault(m, []).append(qi)
    chunks = []
    for m, qids in sorted(buckets.items()):
        per_chunk = max(1, max_rows_per_chunk // (m * m))
        for i in range(0, len(qids), per_chunk):
            chunks.append((m, qids[i:i + per_chunk]))
    return chunks


class RankingObjective(ObjectiveFunction):
    need_group = True

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.seed = config.objective_seed

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.boundaries = np.asarray(metadata.query_boundaries,
                                     dtype=np.int64)
        self.num_queries = len(self.boundaries) - 1
        self._chunks = _bucket_queries(self.boundaries)
        self._batches = _batch_chunks(self._chunks, self.boundaries)
        self._dev_batches = {}

    def _batch_tensors(self, device):
        """Per batch on ``device``: idx [Q, M] row ids (0 on pad slots),
        valid [Q, M], the flat slot positions of the valid slots and
        their row ids (the scatter back to rows, with no host read), the
        batch's per-query float32 constants (``_query_consts``) and its
        chunks' query counts."""
        key = str(device)
        if key not in self._dev_batches:
            out = []
            for idx, valid, qids, counts in self._batches:
                sel = np.flatnonzero(valid.ravel())
                # tpulint: sync-ok(once per device: cached in _dev_batches)
                out.append((torch.as_tensor(idx, device=device),
                            # tpulint: sync-ok(once per device: cached in _dev_batches)
                            torch.as_tensor(valid, device=device),
                            # tpulint: sync-ok(once per device: cached in _dev_batches)
                            torch.as_tensor(sel, device=device),
                            # tpulint: sync-ok(once per device: cached in _dev_batches)
                            torch.as_tensor(idx.ravel()[sel], device=device),
                            self._query_consts(qids, device), counts))
            self._dev_batches[key] = out
        return self._dev_batches[key]

    def _query_consts(self, qids, device):
        return None

    def _batch_extra(self, batch, device):
        """The second operand of ``_chunk_lambdas`` for a batch."""
        return batch[4]

    def get_gradients(self, score):
        """(grad, hess) [N] float32 from the [N] row-order scores: each
        row takes its slot's value plus 0.0, as the JAX package's
        scatter-add into zeros gives (a -0.0 becomes +0.0)."""
        dev = score.device
        grad = torch.zeros(self.num_data, dtype=torch.float32, device=dev)
        hess = torch.zeros(self.num_data, dtype=torch.float32, device=dev)
        for batch in self._batch_tensors(dev):
            idx, valid, sel, rows = batch[:4]
            lam, hes = self._chunk_lambdas(score, idx, valid,
                                           self._batch_extra(batch, dev))
            grad[rows] = lam.reshape(-1)[sel] + 0.0
            hess[rows] = hes.reshape(-1)[sel] + 0.0
        return grad, hess


# pair slots (Q x M x M) of one batch of same-size chunks: each pairwise
# float32 tensor of a batch takes up to 128 MiB
_BATCH_PAIRS = 1 << 25


def _batch_chunks(chunks, boundaries):
    """The JAX package's chunks of one padded size M, in order, merged
    into batches of at most ``_BATCH_PAIRS`` pair slots (the sums of a
    query do not depend on the other queries of its program, so a batch
    gives each query the bits its chunk gives; a chunk of M = 2048 alone
    already holds 2^22 slots). Returns [(idx, valid, query ids, the
    chunks' query counts)]."""
    out, cur = [], []

    def flush():
        if not cur:
            return
        m = cur[0][0]
        qids = np.concatenate([np.asarray(q) for _, q in cur])
        idx = np.zeros((len(qids), m), dtype=np.int64)
        valid = np.zeros((len(qids), m), dtype=bool)
        for r, q in enumerate(qids):
            b, e = boundaries[q], boundaries[q + 1]
            idx[r, :e - b] = np.arange(b, e)
            valid[r, :e - b] = True
        out.append((idx, valid, qids, [len(q) for _, q in cur]))
        cur.clear()
    for m, qids in chunks:
        if cur and (cur[0][0] != m or (sum(len(q) for _, q in cur)
                                       + len(qids)) * m * m > _BATCH_PAIRS):
            flush()
        cur.append((m, qids))
    flush()
    return out


class LambdarankNDCG(RankingObjective):
    name = "lambdarank"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.dcg = DCGCalculator(config.label_gain)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.dcg.check_label(self.label)
        inv = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            b, e = self.boundaries[q], self.boundaries[q + 1]
            maxdcg = self.dcg.cal_max_dcg_at_k(self.truncation_level,
                                               self.label[b:e])
            inv[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0
        self.inverse_max_dcgs = inv
        self._gain32 = self.dcg.label_gain.astype(np.float32)

    def _query_consts(self, qids, device):
        return torch.as_tensor(self.inverse_max_dcgs[qids].astype(np.float32),
                               device=device)

    def _chunk_lambdas(self, score, idx, valid, inv_max_dcg):
        """One padded bucket: [Q, M] gathered scores / labels -> [Q, M]
        lambdas and hessians in query order, with the float32 ops of
        the JAX package's jitted program (the pair terms in its
        multiplication order; its sums in ``_row_sums`` /
        ``_total_sum`` order)."""
        dev = score.device
        f32 = torch.float32
        q, m = idx.shape
        label = self._on(dev, "label")
        gain_tab = self._on(dev, "_gain32")
        s = torch.where(valid, score[idx].to(f32), -math.inf)
        lab = torch.where(valid, label[idx], -1.0)
        # + 0.0: -0.0 and 0.0 tie, as in XLA's sort (a radix sort on
        # the card would order them)
        order = torch.argsort(-s + 0.0, dim=1, stable=True)
        s_s = torch.gather(s, 1, order)
        lab_s = torch.gather(lab, 1, order).to(torch.int32)
        val_s = torch.gather(valid, 1, order)
        cnt = valid.sum(dim=1)
        disc = _discount(m, dev)
        gain = gain_tab[torch.clamp(lab_s, min=0).long()]

        best = s_s[:, 0]
        worst = torch.gather(s_s, 1,
                             torch.clamp(cnt - 1, min=0)[:, None])[:, 0]

        pair_ok = ((lab_s[:, :, None] > lab_s[:, None, :])
                   & val_s[:, :, None] & val_s[:, None, :])
        ds = s_s[:, :, None] - s_s[:, None, :]
        paired_disc = torch.abs(disc[:, None] - disc[None, :])
        delta = ((gain[:, :, None] - gain[:, None, :]) * paired_disc) \
            * inv_max_dcg[:, None, None]
        if self.norm:
            scale = torch.where((best != worst)[:, None, None],
                                1.0 / (torch.abs(ds) + 0.01), 1.0)
            delta = delta * scale
        sig = self.sigmoid
        # XLA drops the product by a sigmoid of 1
        p0 = 1.0 / (exp_f32(ds if sig == 1.0 else ds * sig) + 1.0)
        p_lambda = torch.where(pair_ok, (delta * -sig) * p0, 0.0)
        p_hess = torch.where(pair_ok,
                             ((p0 * (1.0 - p0)) * (sig * sig)) * delta, 0.0)
        del ds, delta, p0, pair_ok
        a, b, c, d = _row_sums(p_lambda, p_hess,
                               not self.norm and sig == 1.0)
        lam_s = a - b
        hes_s = c + d
        if self.norm:
            sum_lambdas = -2.0 * _total_sum(p_lambda, best == worst)
            nf = torch.where(sum_lambdas > 0,
                             (_log_f32(sum_lambdas + 1.0) * _INV_LN2)
                             / torch.clamp(sum_lambdas, min=1e-20), 1.0)
            lam_s = lam_s * nf[:, None]
            hes_s = hes_s * nf[:, None]
        lam = torch.zeros_like(lam_s).scatter_(1, order, lam_s)
        hes = torch.zeros_like(hes_s).scatter_(1, order, hes_s)
        return lam, hes


# log2(x) in the JAX package's program: XLA's log(x) times this float32
# constant (1 / ln 2)
_INV_LN2 = f32_value(1.44269502)


def _discount(m: int, device) -> torch.Tensor:
    """1 / log2(i + 2) for the M positions of a bucket, as XLA computes
    it: its float32 log times 1 / ln 2, then a true division."""
    ar = torch.arange(m, dtype=torch.float32, device=device) + 2.0
    return 1.0 / (_log_f32(ar) * _INV_LN2)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, element by element in order."""
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        out = out + x[..., i]
    return out


def _halve(v: torch.Tensor) -> torch.Tensor:
    """LLVM's horizontal float add of a vector (the last axis, a power
    of two): the upper half added onto the lower half until one lane
    is left."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lane_sum(x: torch.Tensor, accs: int) -> torch.Tensor:
    """A vectorized float reduction over the last axis, as LLVM emits it
    for XLA's reassociable reduce: 8-float vectors taken in order into
    ``accs`` interleaved accumulators, the accumulators added in order,
    then ``_halve``."""
    m = x.shape[-1]
    blocks = x.reshape(*x.shape[:-1], m // _LANES, _LANES)
    accs = min(accs, m // _LANES)
    acc = [blocks[..., k, :] for k in range(accs)]
    for k in range(accs, m // _LANES):
        acc[k % accs] = acc[k % accs] + blocks[..., k, :]
    v = acc[0]
    for k in range(1, accs):
        v = v + acc[k]
    return _halve(v)


_LANES = 8
# XLA:CPU splits a reduce longer than this into windows of this size
_WINDOW = 32


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """A reduce over the last axis longer than ``_WINDOW``: windows of 32
    summed in order, then the window totals the same way (the JAX
    package's reduce-window rewrite)."""
    m = x.shape[-1]
    if m <= _WINDOW:
        return _seq_sum(x)
    part = _seq_sum(x.reshape(*x.shape[:-1], m // _WINDOW, _WINDOW))
    return _window_sum(part)


def _row_sums(p_lambda, p_hess, plain_hess: bool):
    """The four pair sums of every document of a [Q, M, M] bucket: each
    row and each column of the lambdas and of the hessians, in the
    order XLA:CPU sums them in the JAX package's program (read off its
    dumped IR; jaxlib 0.9.0, ROADMAP §C). Up to 32 documents LLVM
    vectorizes each sum over 8-float lanes, with its interleaving per
    bucket size and fusion; from 64 the sums run over windows of 32."""
    m = p_lambda.shape[-1]
    lam_t, hes_t = p_lambda.transpose(1, 2), p_hess.transpose(1, 2)
    if m > _WINDOW:
        return tuple(_window_sum(x) for x in (p_lambda, lam_t, p_hess,
                                              hes_t))
    if m == _LANES:
        return tuple(_seq_sum(x) for x in (p_lambda, lam_t, p_hess, hes_t))
    # interleaved accumulators of each sum: row and column of the
    # lambdas, row and column of the hessians; the hessians' column sum
    # takes one accumulator in the plainest program (no norm, sigmoid 1)
    accs = (1, 2, 1, 1 if plain_hess else 2)
    return tuple(_lane_sum(x, k) for x, k in zip(
        (p_lambda, lam_t, p_hess, hes_t), accs))


def _total_sum(p_lambda: torch.Tensor, tied: torch.Tensor) -> torch.Tensor:
    """[Q] sums of all pair lambdas of each query in the JAX program's
    order: at 8 documents a lane per row, each summing its row in order;
    at 16 and 32 the rows in order, each row's 8-float vectors with the
    running total in lane 0, in one accumulator, or in two for a query
    whose scores all tie (``tied``: LLVM unswitches the loop on the
    norm's scale test); from 64, windows of 32 x 32 summed row by row
    (the window totals again so while more than 32 x 32 of them), then
    the window totals: up to 8 rows of them a lane per row summing its
    row in order, from 16 rows all of them in order."""
    q, m, _ = p_lambda.shape
    if m == _LANES:
        return _halve(_seq_sum(p_lambda))
    if m <= _WINDOW:
        out = []
        for accs in (1, 2):
            total = torch.zeros(q, dtype=p_lambda.dtype,
                                device=p_lambda.device)
            for i in range(m):
                row = p_lambda[:, i].clone()
                row[:, 0] = row[:, 0] + total
                total = _lane_sum(row, accs)
            out.append(total)
        return torch.where(tied, out[1], out[0])
    part = p_lambda
    while part.shape[-1] > _WINDOW:
        k = part.shape[-1] // _WINDOW
        win = part.reshape(q, k, _WINDOW, k, _WINDOW).permute(0, 1, 3, 2, 4)
        part = _seq_sum(win.reshape(q, k, k, _WINDOW * _WINDOW))
    k = part.shape[-1]
    if k > _LANES:
        return _seq_sum(part.reshape(q, k * k))
    return _halve(_seq_sum(part))


# exp2(x) in the JAX package's program: XLA's exp of x times ln 2
_LN2 = f32_value(0.693147182)
class RankXENDCG(RankingObjective):
    name = "rank_xendcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._rng = np.random.RandomState(self.seed)

    def _chunk_lambdas(self, score, idx, valid, rands):
        """reference RankXENDCG::GetGradientsForOneQuery
        (rank_objective.hpp:304-357): third-order XE-NDCG approximation,
        with the float32 ops of the JAX package's jitted program: exp2
        as exp(x · ln 2), its softmax, the multiply-adds LLVM contracts
        and its sums' order (in order, over windows of 32 from 64
        documents)."""
        f32 = torch.float32
        dev = score.device
        m = idx.shape[1]
        label = self._on(dev, "label")
        s = torch.where(valid, score[idx].to(f32), -math.inf)
        lab = torch.where(valid, label[idx], 0.0)
        cnt = valid.sum(dim=1)
        e = exp_f32(s - torch.amax(s, dim=1, keepdim=True))
        rho = torch.where(valid, e / _window_sum(e)[:, None],
                          0.0)
        phi = torch.where(valid, exp_f32(torch.floor(lab) * _LN2) - rands,
                          0.0)
        inv_den = 1.0 / torch.clamp(_window_sum(phi), min=1e-15)
        term1 = fma_f32(-phi, inv_den[:, None], rho)
        one_rho = torch.clamp(1.0 - rho, min=1e-15)
        params = torch.where(valid, term1 / one_rho, 0.0)
        sum_l1 = _window_sum(params)[:, None]
        params2 = torch.where(valid, (rho * (sum_l1 - params)) / one_rho,
                              0.0)
        sum_l2 = _window_sum(params2)[:, None]
        lam = fma_f32(rho, sum_l2 - params2,
                      fma_f32(rho, sum_l1 - params, term1))
        hes = rho * (1.0 - rho)
        drop = (cnt <= 1)[:, None] | ~valid
        return torch.where(drop, 0.0, lam), torch.where(drop, 0.0, hes)

    def _batch_extra(self, batch, device):
        """The batch's draws: one ``rand(Q, M)`` per chunk, in order."""
        m = batch[0].shape[1]
        return torch.as_tensor(np.concatenate(
            [self._rng.rand(q, m).astype(np.float32) for q in batch[5]]),
            device=device)
