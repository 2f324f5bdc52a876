"""Evaluation metrics.

The port of the JAX package's metric layer, as far as the main path
needs it: ``Metric``, ``BinaryLoglossMetric`` and the sort-based
``AUCMetric`` (reference binary_metric.hpp:159). Metrics reduce on the
device that holds the score, so evaluation transfers scalars, never
the [N] score.

``_sum_dev`` is the port of the JAX package's compensated device sum.
On the TPU, which has no float64, that sum runs a Neumaier
compensation in float32 to stay within ~1e-7 of the float64 sum; the
card (and the CPU) have float64, so here it is a float64 reduction —
the result the compensated sum approximates.

The other metrics are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils import log


def _sum_dev(x: torch.Tensor) -> torch.Tensor:
    """float64 sum of a device tensor (0-d float64, on its device)."""
    return torch.sum(x.to(torch.float64))


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
        self._dev_cache = {}

    def _on(self, device, name: str, arr: Optional[np.ndarray]):
        key = (name, str(device))
        if arr is None:
            return None
        if key not in self._dev_cache:
            self._dev_cache[key] = torch.as_tensor(
                np.asarray(arr, np.float32), device=device)
        return self._dev_cache[key]

    def eval_device(self, score: torch.Tensor, objective=None
                    ) -> List[Tuple[str, torch.Tensor]]:
        """[(name, 0-d tensor on the score's device)]."""
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval_device(self, score, objective=None):
        y = self._on(score.device, "label", self.label)
        p = objective.convert_output(score) if objective is not None \
            else score
        p = torch.clamp(p, 1e-15, 1 - 1e-15)
        loss = torch.where(y > 0, -torch.log(p), -torch.log(1 - p))
        w = self._on(score.device, "weights", self.weights)
        if w is None:
            val = _sum_dev(loss) / loss.shape[0]
        else:
            val = _sum_dev(loss * w) / _sum_dev(w)
        return [(self.name, val)]


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


_REGISTRY = {"auc": AUCMetric, "binary_logloss": BinaryLoglossMetric}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    cls = _REGISTRY.get(name)
    if cls is None:
        if name not in ("", "custom"):
            log.warning("Metric %s is not ported yet (ROADMAP A9), ignored",
                        name)
        return None
    return cls(config)
