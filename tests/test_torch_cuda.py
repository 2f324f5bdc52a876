"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip without a CUDA
device; on a machine with one (which need not have JAX) run them with
``python -m pytest tests/test_torch_cuda.py -m cuda``. chip_smoke.py
runs the same comparisons at the main path's full shapes."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import plane as tplane


def _state(n, g, seed):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 255, size=(n, g)).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    lay = tplane.make_layout(g, 8, n, with_label=True, with_score=True)
    t = torch.as_tensor
    data = tplane.build_data(lay, tplane.build_codes_planes(t(codes), lay),
                             t(grad), t(hess), label=t(grad), score=t(hess))
    return lay, data


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    lay, data = _state(50_000, 28, seed=4)
    dev = data.cuda()
    kw = dict(num_bins=255, num_cols=28, code_bits=8, grad_plane=lay.grad,
              dtype=dtype)
    for start, count in ((0, 50_000), (333, 20_001), (7, 3), (9, 0)):
        got = TH.hist_planar_cuda(dev, start, count, **kw)
        again = TH.hist_planar_cuda(dev, start, count, **kw)
        assert torch.equal(got, again)
        torch.testing.assert_close(got.cpu(), TH.histogram_planar_plain(
            data, start, count, **kw), rtol=1e-5, atol=1e-4)
        rs = tplane.route_scalars(lay, 3, 100, 1, miss_bin=7)
        a, na = tplane.partition_cuda(dev.clone(), lay, start, count,
                                      rs.cuda())
        b, nb = tplane.partition_plain(data.clone(), lay, start, count, rs)
        assert int(na) == int(nb)
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_training_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 8)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.randn(5000) > 0).astype(float)
    preds = []
    for dev in ("cuda", "cpu"):
        b = lgt.train({"objective": "binary", "device_type": dev,
                       "tpu_hist_dtype": "float32", "verbose": -1},
                      lgt.Dataset(X, label=y), num_boost_round=3,
                      verbose_eval=False)
        preds.append(b.predict(X))
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-5)
