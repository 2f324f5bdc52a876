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
from ..utils import log


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp evaluated in float64 and rounded: the card's and the
    CPU's float32 exp differ in the last bit, which would make their
    gradients, and so their trees, drift apart; the rounded float64
    result is the same on both (but for a double-rounding case about
    once in 2^29 values)."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


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
        self._row_consts = None     # (device, sign, lw, weights) tensors

    def persistent_aux(self):
        # one aux plane: signed per-row weight sign*lw*w (sign in {+-1},
        # lw*w > 0) — recovered as sign() / abs() in persistent_grads
        aux = self._sign * self._lw
        if self.weights is not None:
            aux = aux * self.weights
        return aux, None

    def get_gradients(self, score):
        # the JAX package's BinaryLogloss.get_gradients: sign and label
        # weight as float32 constants, the row weights applied last
        dev = score.device
        if self._row_consts is None or self._row_consts[0] != dev:
            self._row_consts = (dev, *(
                None if a is None else torch.as_tensor(a, device=dev)
                for a in (self._sign, self._lw, self.weights)))
        _, sign, lw, w = self._row_consts
        s = score.to(torch.float32)
        response = -sign * self.sigmoid / \
            (1.0 + _exp_f32(sign * self.sigmoid * s))
        abs_resp = torch.abs(response)
        g = response * lw
        h = abs_resp * (self.sigmoid - abs_resp) * lw
        if w is not None:
            g, h = g * w, h * w
        return g, h

    def persistent_grads(self, score, label, weight):
        sign = torch.sign(label)
        lw = torch.abs(label)
        response = -sign * self.sigmoid / \
            (1.0 + _exp_f32(sign * self.sigmoid * score))
        abs_resp = torch.abs(response)
        g = response * lw
        h = abs_resp * (self.sigmoid - abs_resp) * lw
        return g, h

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
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

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
