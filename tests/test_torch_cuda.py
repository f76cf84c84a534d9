"""The CUDA fused MLP forward against its plain PyTorch version, on the
card. Imports no JAX, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params

pytestmark = pytest.mark.cuda

# f32: the same products summed in another order (see chip_smoke.py);
# bf16: plus an occasional activation rounded to the neighbouring bf16.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _xT(rows, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-4, 4, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "model, rows",
    [(NerfMLP(Lp=4, Ld=2, H=32), 1000), (NerfMLP(Lp=3, Ld=1, H=48), 64),
     (NerfMLP(), 4096 + 17)],
    ids=["small-ragged", "odd-widths", "flagship-ragged"],
)
def test_kernel_matches_plain(dev, model, rows, dtype):
    field = NerfField.from_jax_params(init_nerf_params(0, model), dev)
    wts = mlp._cast_weights(mlp.pack_weights(field), dtype)
    x = _xT(rows, dev)
    before = mlp.fused_mlp_forward.launches
    got = mlp.fused_mlp_forward(wts, x, dtype, model)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_forward.launches == before + 1
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model)
    assert got.shape == (8, rows) and bool(torch.isfinite(got).all())
    assert bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_bad_inputs(dev):
    model = NerfMLP(Lp=4, Ld=2, H=32)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    with pytest.raises(ValueError, match="contiguous"):
        mlp.fused_mlp_forward(wts, _xT(256, dev).T.contiguous().T, torch.float32, model)
    with pytest.raises(ValueError, match="xT"):
        mlp.fused_mlp_forward(wts, _xT(256, dev)[:6], torch.float32, model)
    with pytest.raises(ValueError, match="W1"):
        mlp.fused_mlp_forward(wts._replace(W1=wts.W1.cpu()), _xT(256, dev), torch.float32, model)
    with pytest.raises(ValueError, match="H <= 256"):
        big = NerfMLP(Lp=2, Ld=2, H=272)
        mlp.fused_mlp_forward(mlp.pack_weights(NerfField(big, device=dev)), _xT(64, dev), torch.float32, big)
