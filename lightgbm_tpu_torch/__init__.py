"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, held against it by the tests in
tests/test_torch_*.py. It imports torch and numpy, never jax, and
nothing of lightgbm_tpu. The hot kernels of training — the planar
histogram and the stable window partition — are hand-written CUDA for
Hopper (csrc/), built with nvcc at first use; every kernel has a plain
PyTorch version beside it that runs on the CPU.

Entry points run on the card unless the params ask for the CPU
(``device_type="cpu"``). It trains every objective of the JAX package
on one device (binary, the regression family, cross-entropy,
multiclass, custom objectives, and ranking: ``lambdarank`` and
``rank_xendcg`` with the ``ndcg`` / ``map`` metrics), categorical
columns included, and predicts with the packed forest or the path
forest; ``cv``, continued training (``init_model``), model files, text
or binary dataset files, SHAP contributions (``pred_contrib``), C++
code generation, the scikit-learn wrappers, the plotting functions and
the command line (``python -m lightgbm_tpu_torch config=train.conf``)
follow the JAX package's API. scikit-learn, matplotlib and graphviz are
optional: the estimators fall back to standalone bases, and the
plotting functions import their libraries when called.
"""

__version__ = "0.1.0"

from .basic import Booster, Dataset, LightGBMError
from .callback import (early_stopping, log_evaluation, print_evaluation,
                       record_evaluation, record_metrics, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train

from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)

__all__ = [
    "Booster", "CVBooster", "Config", "Dataset", "LightGBMError", "cv",
    "early_stopping", "log_evaluation", "print_evaluation",
    "record_evaluation", "record_metrics", "reset_parameter", "train",
    "LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor",
    "create_tree_digraph", "plot_importance", "plot_metric",
    "plot_split_value_histogram", "plot_tree",
]
