"""The CUDA kernels (fused MLP forward, backward, train step) against
their plain PyTorch versions, on the card. Imports no JAX, so it runs on a machine with the card alone:

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


# --- the backward (B2) and train-step (B1) kernels ---------------------------

# Gradients: per tensor, max abs error over the plain version's max abs
# value. f32: the kernels sum the same products in another order (row
# chunks, then the chunk partials); 1e-4 of the largest entry bounds that
# for sums over thousands of rows. bf16: rounding every operand to bf16
# moves these gradients 5-10% (of the largest entry) away from the f32
# result on random cotangents, measured on the card; the kernel and the
# plain version are each that far from f32 and about 10x closer to each
# other (0.2-3%), because a different summation order flips the rounding
# of an occasional activation or cotangent and the layers below carry it.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# Loss, relative: f32 sums in another order; bf16 carries the forward's
# output differences (TOL above) into the ray colours.
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _grad_errors(got, want):
    return {n: ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for n, g, w in zip(want._fields, got, want)}


def _x16(B, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.1, (B, 3))
    d = rng.normal(size=(B, 3))
    ts = np.sort(rng.uniform(2, 6, (B, N)), -1)
    x = np.zeros((16, B, N), np.float32)
    x[0:3] = o.T[:, :, None] + d.T[:, :, None] * ts[None]
    x[3:6] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).T[:, :, None]
    x[6] = ts
    x[8:11] = rng.uniform(0, 1, (3, B, 1))
    return torch.from_numpy(x.reshape(16, B * N)).to(dev)


CASES = [(NerfMLP(Lp=4, Ld=2, H=32), 1000), (NerfMLP(Lp=3, Ld=1, H=48), 64),
         (NerfMLP(), 4096 + 17)]
CASE_IDS = ["small-ragged", "odd-widths", "flagship-ragged"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", CASES, ids=CASE_IDS)
def test_backward_kernel_matches_plain(dev, model, rows, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _xT(rows, dev)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(8, rows)).astype(np.float32)).to(dev)
    before = mlp.fused_mlp_backward.launches
    got = mlp.fused_mlp_backward(wts, x, g, dtype, model)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_backward.launches == before + 1
    want = mlp.fused_mlp_backward_plain(wts, x, g, dtype, model)
    errs = _grad_errors(got, want)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 7, 24),
                                         (NerfMLP(Lp=3, Ld=1, H=48), 3, 5),
                                         (NerfMLP(), 40, 128)],
                         ids=["small", "odd-widths-short-rays", "flagship"])
def test_train_step_kernel_matches_plain(dev, model, B, N, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    before = mlp.fused_train_step.launches
    loss, got = mlp.fused_train_step(wts, x16, N, dtype, model)
    torch.cuda.synchronize()
    assert mlp.fused_train_step.launches == before + 1
    loss_p, want = mlp.fused_train_step_plain(wts, x16, N, dtype, model)
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    loss2, again = mlp.fused_train_step(wts, x16, N, dtype, model)  # deterministic
    assert loss2.item() == loss.item()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_backward_wrappers_reject_bad_inputs(dev):
    model = NerfMLP(Lp=4, Ld=2, H=32)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    x = _xT(256, dev)
    with pytest.raises(ValueError, match="gT"):
        mlp.fused_mlp_backward(wts, x, torch.zeros(8, 128, device=dev), torch.float32, model)
    with pytest.raises(ValueError, match="whole rays"):
        mlp.fused_train_step(wts, _x16(4, 8, dev), 7, torch.float32, model)
    with pytest.raises(ValueError, match="x16"):
        mlp.fused_train_step(wts, _x16(4, 8, dev)[:8].contiguous(), 8, torch.float32, model)
    with pytest.raises(ValueError, match="Wcs"):
        mlp.fused_train_step(wts._replace(Wcs=wts.Wcs.cpu()), _x16(4, 8, dev), 8, torch.float32, model)


def test_fused_train_step_on_the_card(dev, tmp_path):
    """One step of the training path: pallas backend, bf16, the fused
    kernel launched once, the field's parameters moved."""
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    cfg = TrainConfig(datapath=str(tmp_path), Nf=32, batch_size=256, backend="pallas",
                      compute_dtype="bf16", net_H=64, net_Lp=4, net_Ld=2)
    model = NerfMLP(Lp=4, Ld=2, H=64)
    state = make_train_state(cfg, model, dev)
    rays = torch.cat([torch.zeros(1000, 3), torch.randn(1000, 3)], 1).to(dev)
    rays[:, :3] = rays[:, 3:] * -4.0
    pixels = torch.rand(1000, 3, device=dev)
    w0 = state.field.trunk1.weight.detach().clone()
    before = mlp.fused_train_step.launches
    loss = build_train_step(cfg, model)(state, rays, pixels)
    assert mlp.fused_train_step.launches == before + 1
    assert bool(torch.isfinite(loss)) and state.step == 1
    assert not torch.equal(w0, state.field.trunk1.weight)


def test_fused_mlp_autograd_on_the_card(dev):
    """fused_mlp's backward is the backward kernel, and its gradients reach
    the field through the differentiable pack."""
    model = NerfMLP(Lp=4, Ld=2, H=32)
    field = NerfField.from_jax_params(init_nerf_params(0, model), dev)
    x = _xT(512, dev)
    before = mlp.fused_mlp_backward.launches
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), x, torch.float32, model)
    (out[:4] ** 2).sum().backward()
    assert mlp.fused_mlp_backward.launches == before + 1
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in field.parameters())
