"""Evaluation metrics.

The port of the JAX package's pointwise metrics (reference
regression_metric.hpp, binary_metric.hpp, xentropy_metric.hpp) and its
sort-based ``AUCMetric`` (binary_metric.hpp:159). Every metric reduces
on the device that holds the score, so evaluation transfers scalars,
never the [N] score.

``_sum_dev`` is the port of the JAX package's compensated device sum.
On the TPU, which has no float64, that sum runs a Neumaier
compensation in float32 to stay within ~1e-7 of the float64 sum; the
card (and the CPU) have float64, so here it is a float64 reduction —
the result the compensated sum approximates.

The JAX package reduces five metrics on its device (``l2``, ``rmse``,
``l1``, ``binary_logloss``, ``binary_error``: a float32 loss, then
``_sum_dev``) and evaluates the others on the host in numpy float64 over
the converted float32 scores. The port keeps each metric's loss in the
same precision (``f32_loss``), and takes the per-row terms that depend
only on the labels from the same numpy code, so the values agree to the
last bits of the sum's order.

The multiclass metrics (multiclass_metric.hpp) read the [K, N] class
scores (``all_classes``). The JAX package evaluates them on the host in
numpy: ``multi_logloss`` over the float32 class probabilities, so its
logs and mean run in float32 there, and ``auc_mu`` over a matrix
product and a stable sort. The port computes their per-row inputs on the
device (the probability of each row's class, each row's top-k error,
the raw scores) and finishes with the same numpy code on the host
(``finish``), so the values are the JAX package's. Every metric of an
evaluation rides one host read (``GBDT.eval_at_iter``). The ranking
metrics (rank_metric.hpp: ``ndcg``, ``map`` at each ``eval_at`` k) read
the scores on the host, as the JAX package does, and finish in its
float64 numpy code.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops.xla_float import f32_reciprocal
from ..utils import log


def _sum_dev(x: torch.Tensor) -> torch.Tensor:
    """float64 sum of a device tensor (0-d float64, on its device)."""
    return torch.sum(x.to(torch.float64))


def _safe_log(x):
    return torch.log(torch.clamp(x, min=1e-308))


class Metric:
    name = "metric"
    bigger_is_better = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = None if metadata.label is None \
            else np.asarray(metadata.label)
        self.weights = None if metadata.weights is None \
            else np.asarray(metadata.weights)
        # a float32 numpy sum, as the JAX package takes it
        self.sum_weights = float(np.sum(self.weights)) \
            if self.weights is not None else float(num_data)
        self._dev_cache = {}

    def _on(self, device, name: str, arr: Optional[np.ndarray]):
        key = (name, str(device))
        if arr is None:
            return None
        if key not in self._dev_cache:
            # tpulint: sync-ok(once per dataset: cached in _dev_cache)
            self._dev_cache[key] = torch.as_tensor(
                np.asarray(arr, np.float32), device=device)
        return self._dev_cache[key]

    def _label_term(self, device, name: str, fn) -> torch.Tensor:
        """A per-row float64 term that depends on the labels alone,
        ``fn(label)`` in numpy, computed once per device."""
        key = (name, str(device))
        if key not in self._dev_cache:
            with np.errstate(divide="ignore", invalid="ignore"):
                term = fn(self.label)
            self._dev_cache[key] = torch.as_tensor(
                np.asarray(term, np.float64), device=device)
        return self._dev_cache[key]

    # the metric reads the [K, N] scores of every class (else the [N]
    # scores of class 0)
    all_classes = False

    def eval_device(self, score: torch.Tensor, objective=None
                    ) -> List[Tuple[str, torch.Tensor]]:
        """[(name, tensor on the score's device)]: the value as a 0-d
        tensor, or the per-row input of ``finish``."""
        raise NotImplementedError

    def finish(self, host: np.ndarray, name: Optional[str] = None
               ) -> float:
        """The value of entry ``name`` from the host copy (float64) of
        the tensor ``eval_device`` returned for it."""
        return float(host[0])

    def _avg(self, loss: np.ndarray) -> float:
        """The JAX package's host mean of a per-row loss."""
        if self.weights is not None:
            return float(np.sum(loss * self.weights) / self.sum_weights)
        return float(np.mean(loss))


class _Pointwise(Metric):
    """A per-row loss averaged over the rows (weighted by the row
    weights). ``f32_loss``: the JAX package reduces this metric on its
    device, with the loss and the result in float32; else the loss is
    float64 over the float32 labels and converted scores, as its host
    numpy code."""
    f32_loss = False

    def loss(self, y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def finalize(self, avg):
        return avg

    def eval_device(self, score, objective=None):
        dev = score.device
        p = score.to(torch.float32)
        if objective is not None:
            p = objective.convert_output(p)
        y = self._on(dev, "label", self.label)
        w = self._on(dev, "weights", self.weights)
        if self.f32_loss:
            # a float32 value, as the JAX package's device reduction
            # gives: each float64 sum rounded to float32 (what its
            # compensated sum approximates), then a float32 division
            # (XLA divides by the constant row count as a product with
            # its float32 reciprocal)
            loss = self.loss(y, p)
            if w is None:
                avg = _sum_dev(loss).to(torch.float32) \
                    * f32_reciprocal(float(loss.shape[0]))
            else:
                avg = _sum_dev(loss * w).to(torch.float32) \
                    / _sum_dev(w).to(torch.float32)
            return [(self.name, self.finalize(avg))]
        loss = self.loss(y, p.to(torch.float64))
        if w is None:
            avg = _sum_dev(loss) / loss.shape[0]
        else:
            avg = _sum_dev(loss * w.to(torch.float64)) / self.sum_weights
        return [(self.name, self.finalize(avg))]


# --- regression pointwise metrics (regression_metric.hpp) -----------------

class L2Metric(_Pointwise):
    name = "l2"
    f32_loss = True

    def loss(self, y, p):
        return (p - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def finalize(self, avg):
        return torch.sqrt(avg)


class L1Metric(_Pointwise):
    name = "l1"
    f32_loss = True

    def loss(self, y, p):
        return torch.abs(p - y)


class QuantileMetric(_Pointwise):
    name = "quantile"

    def loss(self, y, p):
        delta = y - p
        a = self.config.alpha
        return torch.where(delta < 0, (a - 1.0) * delta, a * delta)


class HuberMetric(_Pointwise):
    name = "huber"

    def loss(self, y, p):
        diff = p - y
        a = self.config.alpha
        return torch.where(torch.abs(diff) <= a, 0.5 * diff * diff,
                           a * (torch.abs(diff) - 0.5 * a))


class FairMetric(_Pointwise):
    name = "fair"

    def loss(self, y, p):
        x = torch.abs(p - y)
        c = self.config.fair_c
        return c * x - c * c * torch.log(1.0 + x / c)


class PoissonMetric(_Pointwise):
    name = "poisson"

    def loss(self, y, p):
        p = torch.clamp(p, min=1e-10)
        return p - y * torch.log(p)


class MAPEMetric(_Pointwise):
    name = "mape"

    def loss(self, y, p):
        return torch.abs(y - p) / torch.clamp(torch.abs(y), min=1.0)


class GammaMetric(_Pointwise):
    name = "gamma"

    def loss(self, y, p):
        theta = -1.0 / torch.clamp(p, min=1e-300)
        b = -_safe_log(-theta)
        # the JAX package's psi = 1 term, log(y) - log(y), in numpy
        # float32 on the labels (0 for positive labels, NaN for a zero)
        c = self._label_term(y.device, "gamma_c", lambda lab: (
            np.log(np.maximum(lab, 1e-308))
            - np.log(np.maximum(lab, 1e-308))))
        return -((y * theta - b) + c)


class GammaDevianceMetric(_Pointwise):
    name = "gamma_deviance"

    def loss(self, y, p):
        tmp = y / (p + 1e-9)
        return tmp - _safe_log(tmp) - 1.0

    def finalize(self, avg):
        # reference AverageLoss: sum_loss * 2 (NOT divided by weights)
        return avg * self.sum_weights * 2 if self.weights is not None \
            else avg * self.num_data * 2


class TweedieMetric(_Pointwise):
    name = "tweedie"

    def loss(self, y, p):
        rho = self.config.tweedie_variance_power
        p = torch.clamp(p, min=1e-10)
        return -y * torch.pow(p, 1 - rho) / (1 - rho) + \
            torch.pow(p, 2 - rho) / (2 - rho)


# --- binary metrics (binary_metric.hpp) -----------------------------------

class BinaryLoglossMetric(_Pointwise):
    name = "binary_logloss"
    f32_loss = True

    def loss(self, y, p):
        p = torch.clamp(p, 1e-15, 1 - 1e-15)
        return torch.where(y > 0, -torch.log(p), -torch.log(1 - p))


class BinaryErrorMetric(_Pointwise):
    name = "binary_error"
    f32_loss = True

    def loss(self, y, p):
        return ((p > 0.5) != (y > 0)).to(torch.float32)


# --- cross entropy (xentropy_metric.hpp) ----------------------------------

def _xent(y, p):
    """-y log p - (1 - y) log(1 - p), float64 p, float32 labels (1 - y
    rounded in float32, as numpy takes it)."""
    p = torch.clamp(p, 1e-15, 1 - 1e-15)
    return -y * torch.log(p) - (1 - y) * torch.log(1 - p)


class CrossEntropyMetric(_Pointwise):
    name = "cross_entropy"

    def loss(self, y, p):
        return _xent(y, p)


class KLDivMetric(_Pointwise):
    name = "kldiv"

    def loss(self, y, p):
        # the label entropy depends on the labels alone: the JAX
        # package's numpy float32 terms, taken once on the host
        def entropy(lab):
            yy = np.clip(lab, 1e-15, 1 - 1e-15)
            return -(yy * np.log(yy) + (1 - yy) * np.log(1 - yy))
        return _xent(y, p) - self._label_term(y.device, "kl_ent", entropy)


class AUCMetric(Metric):
    """Sort-based AUC (reference binary_metric.hpp:159-260) with the
    tie-block semantics of the JAX package: equal scores form one block,
    and a positive and a negative in one block count half a pair."""
    name = "auc"
    bigger_is_better = True

    def eval_device(self, score, objective=None):
        dev = score.device
        y = (self._on(dev, "label", self.label) > 0).to(torch.float64)
        w = self._on(dev, "weights", self.weights)
        w = torch.ones_like(y) if w is None else w.to(torch.float64)
        s, order = torch.sort(score.to(torch.float32), descending=True,
                              stable=True)
        y, w = y[order], w[order]
        pos_w, neg_w = y * w, (1.0 - y) * w
        start = torch.ones_like(s, dtype=torch.int64)
        start[1:] = (s[1:] != s[:-1]).to(torch.int64)
        block = torch.cumsum(start, 0) - 1
        n = s.shape[0]
        bp = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, block, pos_w)
        bn = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, block, neg_w)
        total_pos, total_neg = _sum_dev(pos_w), _sum_dev(neg_w)
        cum_neg_after = total_neg - torch.cumsum(bn, 0)
        acc = _sum_dev(bp * (cum_neg_after + 0.5 * bn))
        denom = total_pos * total_neg
        val = torch.where(denom > 0, acc / denom,
                          torch.ones((), dtype=torch.float64, device=dev))
        return [(self.name, val)]


# --- multiclass (multiclass_metric.hpp) -----------------------------------

class MultiLoglossMetric(Metric):
    """-log of each row's class probability: the float32 probabilities
    of the objective's transform (softmax, or the OVA sigmoids), then the
    JAX package's numpy loss and mean on the host."""
    name = "multi_logloss"
    all_classes = True

    def _probs(self, score, objective):
        """[N, K] probabilities on the device: the objective's float32
        transform, or the float64 softmax of the JAX package's numpy
        fallback."""
        s = score.t()
        if objective is not None:
            return objective.convert_output(s.to(torch.float32))
        s = s.to(torch.float64)
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        return e / e.sum(dim=1, keepdim=True)

    def _label_idx(self, device):
        key = ("label_idx", str(device))
        if key not in self._dev_cache:
            # tpulint: sync-ok(once per dataset: cached in _dev_cache)
            self._dev_cache[key] = torch.as_tensor(
                self.label.astype(np.int64), device=device)[:, None]
        return self._dev_cache[key]

    def eval_device(self, score, objective=None):
        p = self._probs(score, objective)
        self._f32 = p.dtype == torch.float32
        lab = self._label_idx(p.device)
        return [(self.name, torch.gather(p, 1, lab)[:, 0])]

    def finish(self, host, name=None):
        p = host.astype(np.float32) if self._f32 else host
        loss = -np.log(np.maximum(np.clip(p, 1e-15, 1.0), 1e-308))
        return self._avg(loss)


class MultiErrorMetric(MultiLoglossMetric):
    """Top-k error: a row is right when fewer than k classes have a
    higher probability than its class (ties count for it)."""
    name = "multi_error"

    def eval_device(self, score, objective=None):
        p = self._probs(score, objective)
        label_p = torch.gather(p, 1, self._label_idx(p.device))
        rank = torch.sum(p > label_p, dim=1)
        k = max(1, self.config.multi_error_top_k)
        return [(self.name, (rank >= k).to(torch.float64))]

    def finish(self, host, name=None):
        return self._avg(host)


class AucMuMetric(Metric):
    """Multiclass pairwise AUC (reference multiclass_metric.hpp:183
    AucMuMetric, AUC-mu of Kleiman & Page 2019) over the raw class
    scores: each class pair (i, j) ranks the rows of both classes by
    their distance t1 * (v @ s) from the hyperplane v = W[i] - W[j]
    (``auc_mu_weights``, default 1 - I), ties at half credit in a
    stable order; the mean over the K(K-1)/2 pairs. Sample weights do
    not enter. The raw scores go to the host and the JAX package's numpy
    code finishes it (its matrix product's and sort's order)."""
    name = "auc_mu"
    bigger_is_better = True
    all_classes = True

    def eval_device(self, score, objective=None):
        self._shape = tuple(score.shape)
        return [(self.name, score.reshape(-1))]

    def finish(self, host, name=None):
        s = host.reshape(self._shape)
        nc = self.config.num_class
        lab = self.label.astype(np.int64)
        W = np.asarray(self.config.auc_mu_weights, dtype=np.float64)
        if W.size == nc * nc:
            W = W.reshape(nc, nc)
        elif W.size == 0:
            W = 1.0 - np.eye(nc)
        else:
            raise ValueError(
                f"auc_mu_weights must have num_class^2 = {nc * nc} "
                f"entries, got {W.size}")
        total, pairs = 0.0, 0
        for i in range(nc):
            mi = lab == i
            ni = int(mi.sum())
            for j in range(i + 1, nc):
                pairs += 1
                mj = lab == j
                nj = int(mj.sum())
                if ni == 0 or nj == 0:
                    continue
                v = W[i] - W[j]
                d = (v[i] - v[j]) * (v @ s)
                comb = np.concatenate([d[mi], d[mj]])
                order = np.argsort(comb, kind="stable")
                sc = comb[order]
                # average ranks over tie blocks: the rank-sum AUC is
                # P(d_i > d_j) + 0.5 P(d_i == d_j)
                starts = np.concatenate([[True], sc[1:] != sc[:-1]])
                blk = np.cumsum(starts) - 1
                counts = np.bincount(blk)
                avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
                ranks = np.empty(len(comb))
                ranks[order] = avg_rank[blk]
                total += ((ranks[:ni].sum() - ni * (ni + 1) / 2.0)
                          / (ni * nj))
        return total / pairs if pairs else 1.0


class CrossEntropyLambdaMetric(Metric):
    """The cross-entropy of the intensity model over the raw score
    (xentropy_metric.hpp): z = 1 - exp(-w log(1 + exp(s))), in float64;
    the plain mean of the rows (the weights enter z)."""
    name = "cross_entropy_lambda"

    def eval_device(self, score, objective=None):
        dev = score.device
        s = score.to(torch.float64)
        hhat = torch.log1p(torch.exp(s))
        w = self._on(dev, "weights", self.weights)
        w = 1.0 if w is None else w.to(torch.float64)
        z = torch.clamp(1.0 - torch.exp(-w * hhat), 1e-15, 1 - 1e-15)
        y = self._on(dev, "label", self.label)
        # 1 - y rounded in float32, as numpy takes it
        loss = (-y.to(torch.float64) * torch.log(z)
                - (1 - y).to(torch.float64) * torch.log(1 - z))
        return [(self.name, _sum_dev(loss) / loss.shape[0])]


# --- ranking (rank_metric.hpp) --------------------------------------------

class _RankMetric(Metric):
    """A per-query ranking metric at each ``eval_at`` k, averaged over
    the queries. ``eval_device`` returns one entry per k, all of them
    the same float64 scores (read to the host once, with the other
    metrics); ``finish`` runs the JAX package's numpy loop for the
    entry's k."""
    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("%s metric requires query information",
                      self.name.upper())
        self.boundaries = np.asarray(metadata.query_boundaries)
        self.eval_at = list(self.config.eval_at)

    def eval_device(self, score, objective=None):
        s = score.to(torch.float64)
        return [(f"{self.name}@{k}", s) for k in self.eval_at]

    def finish(self, host, name=None):
        k, s = int(name.rsplit("@", 1)[1]), host
        total = 0.0
        for q in range(len(self.boundaries) - 1):
            b, e = self.boundaries[q], self.boundaries[q + 1]
            total += self.query_value(k, self.label[b:e], s[b:e])
        return float(total / (len(self.boundaries) - 1))

    def query_value(self, k: int, label: np.ndarray,
                    score: np.ndarray) -> float:
        raise NotImplementedError


class NDCGMetric(_RankMetric):
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        from ..objective.rank import DCGCalculator
        self.dcg = DCGCalculator(self.config.label_gain)

    def query_value(self, k, label, score):
        maxdcg = self.dcg.cal_max_dcg_at_k(k, label)
        if maxdcg <= 0:
            return 1.0
        return self.dcg.cal_dcg_at_k(k, label, score) / maxdcg


class MapMetric(_RankMetric):
    name = "map"

    def query_value(self, k, label, score):
        lab = (label > 0).astype(np.float64)
        rel = lab[np.argsort(-score, kind="stable")]
        prec = np.cumsum(rel) / (np.arange(len(rel)) + 1.0)
        kk = min(k, len(rel))
        npos = rel[:kk].sum()
        return float(np.sum(prec[:kk] * rel[:kk]) / max(npos, 1.0))


_REGISTRY = {
    "l2": L2Metric,
    "rmse": RMSEMetric,
    "l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "auc_mu": AucMuMetric,
    "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    cls = _REGISTRY.get(name)
    if cls is None:
        if name not in ("", "custom"):
            log.warning("Unknown metric type name: %s", name)
        return None
    return cls(config)
