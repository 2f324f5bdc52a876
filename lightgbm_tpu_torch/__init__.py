"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, held against it by the tests in
tests/test_torch_*.py. It imports torch and numpy, never jax, and
nothing of lightgbm_tpu. The hot kernels of training — the planar
histogram and the stable window partition — are hand-written CUDA for
Hopper (csrc/), built with nvcc at first use; every kernel has a plain
PyTorch version beside it that runs on the CPU.

Entry points run on the card unless the params ask for the CPU
(``device_type="cpu"``). It trains the binary main path,
``train({"objective": "binary"}, Dataset(X, label=y))``, categorical
columns included, and predicts with the packed forest or the path
forest.
"""

__version__ = "0.1.0"

from .basic import Booster, Dataset, LightGBMError
from .callback import early_stopping, log_evaluation, record_evaluation
from .config import Config
from .engine import train

__all__ = [
    "Booster", "Config", "Dataset", "LightGBMError", "early_stopping",
    "log_evaluation", "record_evaluation", "train",
]
