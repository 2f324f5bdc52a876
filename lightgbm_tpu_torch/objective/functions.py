"""Objective functions (gradient/hessian producers).

The port of the JAX package's objective layer, as far as the main path
needs it: the ``ObjectiveFunction`` base and ``BinaryLogloss``
(reference binary_objective.hpp). Gradients are elementwise PyTorch over
score tensors; the per-row label/weight constants live on the host as
numpy and on the learner's device as tensors.

The remaining objectives (regression family, multiclass, cross-entropy,
ranking) are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.xla_float import exp_f32, flush_f32
from ..utils import log


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

    def persistent_renew_spec(self):
        return None

    def get_gradients(self, score: torch.Tensor):
        """(grad, hess) [N] float32 from raw scores [N] in row order
        (the host-loop learner's path)."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def to_string(self) -> str:
        return self.name


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
        self._row_consts = None     # (device, sign, per-row weight)

    def persistent_aux(self):
        # one aux plane: signed per-row weight sign*lw*w (sign in {+-1},
        # lw*w > 0) — recovered as sign() / abs() in persistent_grads
        aux = self._sign * self._lw
        if self.weights is not None:
            aux = aux * self.weights
        return aux, None

    def get_gradients(self, score):
        # the JAX package's BinaryLogloss.get_gradients jits with the
        # label weights and row weights as constants, and XLA folds
        # (x * lw) * w into x * (lw * w): one float32 weight per row
        dev = score.device
        if self._row_consts is None or self._row_consts[0] != dev:
            lw = self._lw if self.weights is None else self._lw * self.weights
            self._row_consts = (dev, torch.as_tensor(self._sign, device=dev),
                                torch.as_tensor(lw, device=dev))
        _, sign, lw = self._row_consts
        return _binary_grads(sign, lw, self.sigmoid, score.to(torch.float32))

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


_REGISTRY = {"binary": BinaryLogloss}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """CreateObjectiveFunction; None for objective=custom."""
    name = config.objective
    if name == "custom":
        return None
    cls = _REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"objective {name!r} is not ported yet (ROADMAP A9); the port "
            "trains objective='binary'")
    return cls(config)
