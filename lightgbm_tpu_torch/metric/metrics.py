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

The multiclass and ranking metrics are not ported yet (ROADMAP A9).
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

    def eval_device(self, score: torch.Tensor, objective=None
                    ) -> List[Tuple[str, torch.Tensor]]:
        """[(name, 0-d tensor on the score's device)]."""
        raise NotImplementedError


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
    "cross_entropy": CrossEntropyMetric,
    "kldiv": KLDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    cls = _REGISTRY.get(name)
    if cls is None:
        if name not in ("", "custom"):
            log.warning("Metric %s is not ported yet (ROADMAP A9), ignored",
                        name)
        return None
    return cls(config)
