"""Objective functions (gradient/hessian producers).

The port of the JAX package's objective layer for every pointwise
objective that runs on the persistent learner: the regression family
(``regression`` with ``reg_sqrt``, ``regression_l1``, ``huber``,
``fair``, ``poisson``, ``quantile``, ``mape``, ``gamma``, ``tweedie``;
reference regression_objective.hpp), ``binary`` (binary_objective.hpp)
and ``cross_entropy`` (xentropy_objective.hpp). Gradients are
elementwise PyTorch over score tensors; the per-row label/weight
constants live on the host as numpy and on the learner's device as
tensors.

Each objective has two gradient forms, as in the JAX package:
``get_gradients`` (the host loop, rows in row order) and
``persistent_grads`` (the fused learner, over the planes that ride the
planar state). The JAX package jits the first with label and weights as
constants, so XLA folds them, and runs the second on runtime planes;
where that gives different float32 bits, the two forms here differ too
(ROADMAP §C). L1, quantile and MAPE refit their leaf values to a
percentile of the residuals (``renew_tree_output`` on the host loop,
``persistent_renew_spec`` for the fused learner's in-program refit).

The objectives that grow K trees per iteration, or none in the
persistent learner's state, take the per-tree path: ``multiclass``
(softmax over the K class scores; multiclass_objective.hpp:24),
``multiclassova`` (K binary objectives, one per class; :186) and
``cross_entropy_lambda`` (xentropy_objective.hpp:185). Their
``get_gradients`` takes the [K, N] (or [N]) row-order scores. So do
the ranking objectives (``lambdarank``, ``rank_xendcg``:
objective/rank.py), over the queries of the dataset's groups.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.xla_float import (exp_f32, f32_value, flush_f32, fma_f32,
                              log1p_f32, softmax_f32)
from ..utils import log


def _np_weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                            alpha: float) -> float:
    """PercentileFun / WeightedPercentileFun, faithful to the reference
    (regression_objective.hpp:18-88). Two quirks of that code are
    mirrored deliberately rather than "fixed": the unweighted rule
    selects DESCENDING at float_pos = (1-alpha)*cnt via ArgMaxAtK
    (so the even-count median of [1,2,3,4] is 3, not 2.5), and the
    weighted rule interpolates only when the next item's cumulative-
    weight step is >= 1.0 — with threshold < cdf[pos], i.e. a negative
    interpolation factor, exactly as the reference computes it."""
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    if weights is None:
        float_pos = (1.0 - alpha) * n
        pos = int(float_pos)
        if pos < 1:
            return float(np.max(values))
        if pos >= n:
            return float(np.min(values))
        bias = float_pos - pos
        d = np.sort(values)[::-1]            # descending, like ArgMaxAtK
        return float(d[pos - 1] - (d[pos - 1] - d[pos]) * bias)
    order = np.argsort(values, kind="stable")
    sv = values[order]
    cdf = np.cumsum(weights[order].astype(np.float64))
    threshold = alpha * cdf[-1]
    pos = int(np.searchsorted(cdf, threshold, side="right"))  # upper_bound
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(sv[pos])
    v1, v2 = float(sv[pos - 1]), float(sv[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) \
            * (v2 - v1) + v1
    return float(v2)


def _binary_grads(sign, lw, sigmoid: float, score):
    """Binary logloss (grad, hess) in the JAX package's float32 ops, with
    the bits its jitted CPU code gives: XLA's float32 ``exp``
    (``exp_f32``, also the same bits on the card) and subnormal results
    flushed to zero (``flush_f32``; they arise for scores far from 0)."""
    response = flush_f32(-sign * sigmoid /
                         (1.0 + exp_f32(sign * sigmoid * score)))
    abs_resp = torch.abs(response)
    g = flush_f32(response * lw)
    h = flush_f32(flush_f32(abs_resp * (sigmoid - abs_resp)) * lw)
    return g, h


def _sigmoid_f32(score):
    """1 / (1 + exp(-score)) as XLA computes it in float32."""
    return flush_f32(1.0 / (1.0 + exp_f32(-score)))


def _weigh(g, h, weight):
    if weight is None:
        return g, h
    return flush_f32(g * weight), flush_f32(h * weight)


class ObjectiveFunction:
    name = "custom"
    num_tree_per_iteration = 1
    is_constant_hessian = False
    is_renew_tree_output = False
    need_group = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = None if metadata.label is None else \
            np.asarray(metadata.label, dtype=np.float32)
        self.weights = None if metadata.weights is None else \
            np.asarray(metadata.weights, dtype=np.float32)
        self._dev_rows = {}

    def _on(self, device, name: str) -> Optional[torch.Tensor]:
        """The per-row float32 array ``self.<name>`` as a tensor on
        ``device`` (cached; None stays None)."""
        key = (name, str(device))
        if key not in self._dev_rows:
            arr = getattr(self, name)
            # tpulint: sync-ok(once per dataset: cached in _dev_rows)
            self._dev_rows[key] = None if arr is None else torch.as_tensor(
                np.asarray(arr, np.float32), device=device)
        return self._dev_rows[key]

    # -- persistent learner hooks (treelearner/fused.py) ----------------
    # Pointwise objectives compute gradients inside the learner's
    # iteration, where rows live in leaf-permuted lane order.
    # ``persistent_aux`` returns (label_plane, weight_plane_or_None) as
    # numpy: per-row constants that travel through the partition
    # alongside the score; ``persistent_grads(score, label, weight)``
    # computes (grad, hess) from those planes. None = not supported.
    def persistent_aux(self):
        return None

    def persistent_grads(self, score, label, weight):
        raise NotImplementedError

    def quantized_grads(self, score, label, weight):
        """``persistent_grads`` as the fused learner's quantized
        iteration computes them: the same ops, but that program can
        contract them differently (tweedie, ROADMAP §C C12)."""
        return self.persistent_grads(score, label, weight)

    def persistent_renew_spec(self):
        """(alpha, weighted) for the fused learner's in-program leaf
        refit (treelearner/fused.py ``_renew_leaf_outputs``), or None
        when the objective has no leaf renewal. ``weighted`` matches
        whether ``persistent_aux`` carries a weight plane: the refit
        reads it as the percentile weights."""
        return None

    def get_gradients(self, score: torch.Tensor):
        """(grad, hess) [N] float32 from raw scores [N] in row order
        (the host-loop learner's path)."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def renew_tree_output(self, pred_leaf: np.ndarray, residuals: np.ndarray,
                          num_leaves: int) -> Optional[np.ndarray]:
        """The host loop's leaf refit (reference RenewTreeOutput, e.g.
        RegressionL1loss's at regression_objective.hpp:249): [num_leaves]
        float64 leaf values, the weighted percentile of each leaf's
        residuals with the weights of the fused learner's weight plane,
        or None (no renewal)."""
        spec = self.persistent_renew_spec()
        if spec is None:
            return None
        weights = self.persistent_aux()[1]
        out = np.zeros(num_leaves)
        for leaf in range(num_leaves):
            m = pred_leaf == leaf
            out[leaf] = _np_weighted_percentile(
                residuals[m], None if weights is None else weights[m],
                spec[0])
        return out

    def to_string(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# regression family (reference regression_objective.hpp)
# ---------------------------------------------------------------------------

class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt and self.label is not None:
            self.label = np.sign(self.label) * np.sqrt(np.abs(self.label))

    def _grads(self, diff):
        """(grad, hess) of the objective from score - label."""
        return diff, torch.ones_like(diff)

    def get_gradients(self, score):
        s = score.to(torch.float32)
        g, h = self._grads(s - self._on(s.device, "label"))
        return _weigh(g, h, self._on(s.device, "weights"))

    def persistent_aux(self):
        return self.label, self.weights

    def persistent_grads(self, score, label, weight):
        return _weigh(*self._grads(score - label), weight)

    def boost_from_score(self, class_id):
        if self.weights is not None:
            return float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        if self.sqrt:
            # sign(raw) * raw * raw with the JAX package's signed zeros
            return raw * torch.abs(raw)
        return raw

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")


class RegressionL1(RegressionL2):
    name = "regression_l1"
    is_renew_tree_output = True

    def _grads(self, diff):
        g = torch.sign(diff)
        return g, torch.ones_like(g)

    def persistent_renew_spec(self):
        return 0.5, getattr(self, "weights", None) is not None

    def boost_from_score(self, class_id):
        return _np_weighted_percentile(self.label, self.weights, 0.5)


class RegressionHuber(RegressionL2):
    name = "huber"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.alpha = config.alpha
        if self.alpha <= 0:
            log.fatal("alpha should be greater than 0 in huber")

    def _grads(self, diff):
        a = f32_value(self.alpha)
        g = torch.where(torch.abs(diff) <= a, diff, torch.sign(diff) * a)
        return g, torch.ones_like(g)


class RegressionFair(RegressionL2):
    name = "fair"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.c = config.fair_c

    def _grads(self, x):
        c = f32_value(self.c)
        d = torch.abs(x) + c
        g = flush_f32(c * x / d)
        # c * c is folded in float64 (a Python product), then rounded
        # (a Python scalar over a tensor is a reciprocal times the
        # scalar in torch, not a division: divide two tensors)
        cc = torch.full((), f32_value(self.c * self.c), dtype=torch.float32,
                        device=x.device)
        h = flush_f32(cc / flush_f32(d * d))
        return g, h

    def boost_from_score(self, class_id):
        return 0.0


class RegressionPoisson(RegressionL2):
    name = "poisson"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.max_delta_step = config.poisson_max_delta_step

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is not None and np.any(self.label < 0):
            log.fatal("[poisson]: at least one target label is negative")

    def _exp_grads(self, s, label):
        g = exp_f32(s) - label
        h = exp_f32(s + f32_value(self.max_delta_step))
        return g, h

    def get_gradients(self, score):
        s = score.to(torch.float32)
        g, h = self._exp_grads(s, self._on(s.device, "label"))
        return _weigh(g, h, self._on(s.device, "weights"))

    def persistent_grads(self, score, label, weight):
        return _weigh(*self._exp_grads(score, label), weight)

    def boost_from_score(self, class_id):
        mean = RegressionL2.boost_from_score(self, class_id)
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, raw):
        return exp_f32(raw)


class RegressionQuantile(RegressionL2):
    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.alpha = config.alpha
        if not (0.0 < self.alpha < 1.0):
            log.fatal("alpha should be in (0, 1) for quantile")

    def _grads(self, delta):
        g = torch.where(delta >= 0, f32_value(1.0 - self.alpha),
                        f32_value(-self.alpha))
        return g, torch.ones_like(g)

    def persistent_renew_spec(self):
        return self.alpha, getattr(self, "weights", None) is not None

    def boost_from_score(self, class_id):
        return _np_weighted_percentile(self.label, self.weights, self.alpha)


class RegressionMAPE(RegressionL1):
    name = "mape"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weights is not None:
            lw = lw * self.weights
        self.label_weight = lw.astype(np.float32)

    def get_gradients(self, score):
        s = score.to(torch.float32)
        dev = s.device
        g = torch.sign(s - self._on(dev, "label")) \
            * self._on(dev, "label_weight")
        w = self._on(dev, "weights")
        return g, (torch.ones_like(g) if w is None else w)

    def persistent_aux(self):
        # the weight plane carries label_weight = w / max(1, |label|):
        # it is both the gradient scale and the renewal percentile
        # weight (reference RegressionMAPELOSS::RenewTreeOutput)
        return self.label, self.label_weight

    def persistent_grads(self, score, label, weight):
        g = torch.sign(score - label) * weight
        # sample weight = label_weight * max(1, |label|)
        h = weight * torch.clamp(torch.abs(label), min=1.0)
        return g, h

    def persistent_renew_spec(self):
        return 0.5, True

    def boost_from_score(self, class_id):
        return _np_weighted_percentile(self.label, self.label_weight, 0.5)


class RegressionGamma(RegressionPoisson):
    name = "gamma"

    # XLA rewrites label / exp(s) as label * exp(-s). Whether it then
    # contracts 1 - label * exp(-s) into one multiply-add depends on the
    # program around it: the jitted get_gradients does so only with row
    # weights, and then folds label * weight into one constant; the
    # fused learner's iteration always does (ROADMAP §C)
    def get_gradients(self, score):
        s = score.to(torch.float32)
        dev = s.device
        label, w = self._on(dev, "label"), self._on(dev, "weights")
        e = exp_f32(-s)
        if w is None:
            return flush_f32(1.0 - label * e), flush_f32(label * e)
        g = flush_f32(flush_f32(fma_f32(-label, e, 1.0)) * w)
        return g, flush_f32(self._on(dev, "label_w") * e)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.label_w = None if self.weights is None \
            else self.label * self.weights

    def _exp_grads(self, s, label):
        e = exp_f32(-s)
        return flush_f32(fma_f32(-label, e, 1.0)), flush_f32(label * e)


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.rho = config.tweedie_variance_power

    def _tweedie_grads(self, s, label, fused_g: bool):
        """-y e1 + e2 and -y (1 - rho) e1 + (2 - rho) e2 with e1 =
        exp((1 - rho) s), e2 = exp((2 - rho) s): the hessian is one
        multiply-add in both programs, the gradient only in the jitted
        get_gradients (ROADMAP §C)."""
        rho = self.rho
        e1 = exp_f32(f32_value(1 - rho) * s)
        e2 = exp_f32(f32_value(2 - rho) * s)
        if fused_g:
            g = flush_f32(fma_f32(-label, e1, e2))
        else:
            g = flush_f32(flush_f32(-label * e1) + e2)
        a = flush_f32(-label * f32_value(1 - rho))
        h = flush_f32(fma_f32(a, e1, flush_f32(f32_value(2 - rho) * e2)))
        return g, h

    def get_gradients(self, score):
        s = score.to(torch.float32)
        g, h = self._tweedie_grads(s, self._on(s.device, "label"), True)
        return _weigh(g, h, self._on(s.device, "weights"))

    def persistent_grads(self, score, label, weight):
        return _weigh(*self._tweedie_grads(score, label, False), weight)

    def quantized_grads(self, score, label, weight):
        # the quantized iteration contracts the gradient, as the jitted
        # get_gradients does (C12)
        return _weigh(*self._tweedie_grads(score, label, True), weight)


# ---------------------------------------------------------------------------
# binary (reference binary_objective.hpp:21)
# ---------------------------------------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    """Binary log loss (reference binary_objective.hpp)."""
    name = "binary"

    def __init__(self, config: Config,
                 is_pos: Optional[Callable] = None) -> None:
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self.is_unbalance = config.is_unbalance
        self.scale_pos_weight = config.scale_pos_weight
        self._is_pos = is_pos or (lambda y: y > 0)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        is_pos = self._is_pos(self.label)
        cnt_pos = int(np.sum(is_pos))
        cnt_neg = num_data - cnt_pos
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Contains only one class")
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self._sign = np.where(is_pos, 1.0, -1.0).astype(np.float32)
        self._lw = np.where(is_pos, w_pos, w_neg).astype(np.float32)
        # the JAX package's BinaryLogloss.get_gradients jits with the
        # label weights and row weights as constants, and XLA folds
        # (x * lw) * w into x * (lw * w): one float32 weight per row
        self._row_lw = self._lw if self.weights is None \
            else self._lw * self.weights

    def persistent_aux(self):
        # one aux plane: signed per-row weight sign*lw*w (sign in {+-1},
        # lw*w > 0) — recovered as sign() / abs() in persistent_grads
        aux = self._sign * self._lw
        if self.weights is not None:
            aux = aux * self.weights
        return aux, None

    def get_gradients(self, score):
        dev = score.device
        return _binary_grads(self._on(dev, "_sign"), self._on(dev, "_row_lw"),
                             self.sigmoid, score.to(torch.float32))

    def persistent_grads(self, score, label, weight):
        return _binary_grads(torch.sign(label), torch.abs(label),
                             self.sigmoid, score)

    def boost_from_score(self, class_id):
        if self.weights is not None:
            suml = float(np.sum(self._is_pos(self.label) * self.weights))
            sumw = float(np.sum(self.weights))
        else:
            suml = float(np.sum(self._is_pos(self.label)))
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, 1e-15), 1e-15), 1.0 - 1e-15)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f", self.name,
                 pavg, initscore)
        return initscore

    def convert_output(self, raw):
        # the JAX package jits this on float32 scores: XLA's exp, flush
        return flush_f32(1.0 / (1.0 + exp_f32(-self.sigmoid * raw)))

    def to_string(self):
        return f"{self.name} sigmoid:{self.sigmoid}"


# ---------------------------------------------------------------------------
# cross entropy (reference xentropy_objective.hpp)
# ---------------------------------------------------------------------------

class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if np.any((self.label < 0) | (self.label > 1)):
            log.fatal("[%s]: label must be in [0, 1]", self.name)

    @staticmethod
    def _xent_grads(s, label, weight):
        z = _sigmoid_f32(s)
        g = z - label
        h = flush_f32(z * (1.0 - z))
        return _weigh(g, h, weight)

    def get_gradients(self, score):
        s = score.to(torch.float32)
        return self._xent_grads(s, self._on(s.device, "label"),
                                self._on(s.device, "weights"))

    def persistent_aux(self):
        return self.label, self.weights

    def persistent_grads(self, score, label, weight):
        return self._xent_grads(score, label, weight)

    def boost_from_score(self, class_id):
        if self.weights is not None:
            pavg = float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        return _sigmoid_f32(raw)


class CrossEntropyLambda(ObjectiveFunction):
    """Cross-entropy over a log-intensity score (reference
    xentropy_objective.hpp:185-213): unweighted it is cross-entropy;
    with weights the probability is 1 - (1 - z)^w."""
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if np.any((self.label < 0) | (self.label > 1)):
            log.fatal("[%s]: label must be in [0, 1]", self.name)

    def get_gradients(self, score):
        s = score.to(torch.float32)
        dev = s.device
        y, w = self._on(dev, "label"), self._on(dev, "weights")
        if w is None:
            z = _sigmoid_f32(s)
            return z - y, flush_f32(z * (1.0 - z))
        # the ops as XLA rewrites the JAX package's jitted program:
        # 1 / exp(s) becomes exp(-s); c / (d d) becomes 1 / ((1 - z) d d)
        # with c = 1 / (1 - z); y b + 1 is one multiply-add
        epf = exp_f32(s)
        ez = exp_f32(log1p_f32(epf) * -w)
        z = 1.0 - ez
        g = flush_f32(flush_f32((1.0 - flush_f32(y / z)) * w)
                      / (exp_f32(-s) + 1.0))
        we = flush_f32(epf * w)
        d = epf + 1.0
        a = flush_f32(we / flush_f32(d * d))
        one_z = 1.0 - z
        c = 1.0 / one_z
        c1 = c - 1.0
        b = flush_f32(flush_f32(1.0 / flush_f32(one_z * flush_f32(c1 * c1)))
                      * ((we + 1.0) - c))
        return g, flush_f32(a * fma_f32(b, y, 1.0))

    def boost_from_score(self, class_id):
        havg = float(np.mean(self.label)) if self.weights is None else \
            float(np.sum(self.label * self.weights) / np.sum(self.weights))
        initscore = float(np.log(max(np.exp(havg) - 1.0, 1e-15)))
        log.info("[%s:BoostFromScore]: havg=%f -> initscore=%f", self.name,
                 havg, initscore)
        return initscore

    def convert_output(self, raw):
        return log1p_f32(exp_f32(raw))


# ---------------------------------------------------------------------------
# multiclass (reference multiclass_objective.hpp:24/:186)
# ---------------------------------------------------------------------------

class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = self.num_class
        self.factor = self.num_class / max(self.num_class - 1.0, 1.0)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lab = self.label.astype(np.int32)
        if np.any((lab < 0) | (lab >= self.num_class)):
            log.fatal("Label must be in [0, %d) for multiclass",
                      self.num_class)
        self.onehot = (lab[None, :] == np.arange(self.num_class)[:, None]
                       ).astype(np.float32)

    def get_gradients(self, score):
        """score: [K, N] raw scores; (grad, hess) [K, N] each."""
        p = softmax_f32(score, dim=0)
        dev = p.device
        g = p - self._on(dev, "onehot")
        h = flush_f32(flush_f32(f32_value(self.factor) * p) * (1.0 - p))
        return _weigh(g, h, self._on(dev, "weights"))

    def convert_output(self, raw):
        """[N, K] raw scores to class probabilities (the last axis)."""
        return softmax_f32(raw, dim=-1)


def _ova_is_pos(k: int) -> Callable:
    return lambda y: np.abs(y - k) < 1e-9


class MulticlassOVA(ObjectiveFunction):
    """One binary log loss per class, label == k positive."""
    name = "multiclassova"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = self.num_class
        self.sigmoid = config.sigmoid
        self._binary: list = []

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._binary = []
        for k in range(self.num_class):
            b = BinaryLogloss(self.config, is_pos=_ova_is_pos(k))
            b.init(metadata, num_data)
            self._binary.append(b)

    def get_gradients(self, score):
        gs, hs = zip(*(b.get_gradients(score[k])
                       for k, b in enumerate(self._binary)))
        return torch.stack(gs), torch.stack(hs)

    def boost_from_score(self, class_id):
        return self._binary[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return flush_f32(1.0 / (1.0 + exp_f32(-self.sigmoid * raw)))


_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """CreateObjectiveFunction; None for objective=custom (``none``):
    the caller then supplies the gradients (reference
    objective_function.cpp:49-51)."""
    name = config.objective
    if name == "custom":
        return None
    if name in ("lambdarank", "rank_xendcg"):
        from .rank import LambdarankNDCG, RankXENDCG
        return (LambdarankNDCG if name == "lambdarank"
                else RankXENDCG)(config)
    cls = _REGISTRY.get(name)
    if cls is None:
        log.fatal("Unknown objective type name: %s", name)
    return cls(config)
