"""The CUDA kernels (fused MLP forward, backward, train step and render;
the forward's residual planes, the weight-gradient sums and the backward
tile kernel alone; the padding probe) against their plain PyTorch
versions, on the card.
Imports no JAX, so it runs on a machine with the card alone:

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


# --- the render kernel (B3) and the padding probe (B4) ---------------------------------

# B3 vs plain: the forward's bounds (TOL) on raw rgb; depth sums w * t with
# t up to 6, so 6x that; acc within TOL. Rows 5..7 and non-head columns 0.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 24),
                                         (NerfMLP(Lp=3, Ld=1, H=48), 3, 5),
                                         (NerfMLP(), 40, 128)],
                         ids=["small-ragged", "odd-widths-short-rays", "flagship"])
def test_render_kernel_matches_plain(dev, model, B, N, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    before = mlp.fused_render.launches
    got = mlp.fused_render(wts, x16, N, dtype, model)
    torch.cuda.synchronize()
    assert mlp.fused_render.launches == before + 1
    want = mlp.fused_render_plain(wts, x16, N, dtype, model)
    assert got.shape == (8, B * N) and bool(torch.isfinite(got).all())
    heads = torch.zeros(B * N, dtype=torch.bool, device=dev)
    heads[::N] = True
    assert bool((got[:, ~heads] == 0).all()) and bool((got[5:] == 0).all())
    err = (got[:5, heads] - want[:5, heads]).abs().amax(1)
    assert err[[0, 1, 2, 4]].max().item() <= TOL[dtype] and err[3].item() <= 6 * TOL[dtype], err


@pytest.mark.parametrize("K", [40, 72, 80, 128])
def test_probe_kernel_matches_plain(dev, K):
    from nerf_simple_tpu_torch.probes import pad_passes

    x, W = pad_passes.inputs(K, 200, dev)  # 200 columns: a ragged last block
    before = pad_passes.pad_passes.launches
    got = pad_passes.pad_passes(x, W, 4)
    torch.cuda.synchronize()
    assert pad_passes.pad_passes.launches == before + 1
    want = pad_passes.pad_passes_plain(x, W, 4)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# --- the weight-gradient sums alone (csrc/wgrad.cuh) ------------------------------

def _wgrad_shapes(model):
    from nerf_simple_tpu_torch.probes import wgrad

    return [(s.O, s.K, s.bias) for s in wgrad.sums(model)[0]]


WGRAD_SHAPES = sorted(set(_wgrad_shapes(NerfMLP()) + _wgrad_shapes(NerfMLP(Lp=4, Ld=2, H=32))))
# Against float64 sums of the operands as stored, over the largest entry:
# f32 rounds each add to nearest; bf16 tensor-core adds do not (B4), so
# 1e-3 there (chip_smoke.py, probes/wgrad.py). Against plain (f32 sums of
# the same rounded operands in another order) the same bounds hold.
WGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("O, K, bias", WGRAD_SHAPES, ids=[f"{o}x{k}" + ("" if b else "-nobias")
                                                           for o, k, b in WGRAD_SHAPES])
def test_weight_grad_kernel_matches_plain_and_f64(dev, O, K, bias, dtype):
    rows = 64 * 1001  # not a multiple of any row split
    rng = np.random.default_rng(O * 1000 + K)
    u, v = rng.random((O, rows), dtype=np.float32), rng.random((K, rows), dtype=np.float32)
    G = torch.from_numpy(np.where(u < 0.5, 0.0, 4 * (u - 0.75)).astype(np.float32)).to(dev, dtype)
    A = torch.from_numpy(np.where(v < 0.5, 0.0, 2 * (v - 0.5)).astype(np.float32)).to(dev, dtype)
    before = mlp.weight_grad.launches
    dW, db = mlp.weight_grad(G, A, bias)
    torch.cuda.synchronize()
    assert mlp.weight_grad.launches == before + 1
    assert dW.shape == (O, K) and dW.dtype == torch.float32 and (db is None) != bias
    want_dW, want_db = mlp.weight_grad_plain(G, A, dtype)
    ref_dW, ref_db = G.double() @ A.double().T, G.double().sum(1)
    scale = ref_dW.abs().max().item()
    for got, want, ref in ((dW, want_dW, ref_dW), (db, want_db, ref_db)):
        if got is None:
            continue
        assert (got - ref).abs().max().item() <= WGRAD_TOL[dtype] * scale
        assert (got - want).abs().max().item() <= WGRAD_TOL[dtype] * scale
    dW2, db2 = mlp.weight_grad(G, A, bias)  # deterministic
    assert torch.equal(dW, dW2) and (db is None or torch.equal(db, db2))


def test_weight_grad_kernel_rejects_misaligned_planes(dev):
    G = torch.zeros(8 * 128 + 1, device=dev)[1:].view(8, 128)
    with pytest.raises(ValueError, match="aligned"):
        mlp.weight_grad(G, torch.zeros(16, 128, device=dev))


def test_train_step_counts_its_weight_gradient_sums(dev):
    model = NerfMLP(Lp=4, Ld=2, H=32)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, torch.float32, model)
    mlp.wgrad_sums_launches(reset=True)
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, torch.float32, model)
    assert mlp.wgrad_sums_launches() >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_weight_grads_in_one_launch_match_plain(dev, dtype):
    """The flagship's twelve sums in one launch, as the backward runs them."""
    from nerf_simple_tpu_torch.probes import wgrad

    ss, FG, FA = wgrad.sums(NerfMLP())
    G, A = wgrad.planes(FG, FA, 64 * 1001, dev, seed=3)
    G, A = G.to(dtype), A.to(dtype)
    pairs = [(G[s.gf : s.gf + s.O], A[s.af : s.af + s.K], s.bias) for s in ss]
    before = mlp.weight_grad.launches
    got = mlp.weight_grads(pairs)
    torch.cuda.synchronize()
    assert mlp.weight_grad.launches == before + 1
    for (g, a, bias), (dW, db) in zip(pairs, got):
        want_dW, want_db = mlp.weight_grad_plain(g, a, dtype)
        scale = want_dW.abs().max().item()
        assert (dW - want_dW).abs().max().item() <= WGRAD_TOL[dtype] * scale
        assert db is None if not bias else (db - want_db).abs().max().item() <= WGRAD_TOL[dtype] * scale
    again = mlp.weight_grads(pairs)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(got, again))


# --- the forward tile kernels (csrc/fwd_bf16.cuh, csrc/fwd_f32.cuh) -----------------

FWD_TILE = 128  # sample rows of a tile of both forward tile kernels
FWD_ROWS = [1, 63, 64, 65, FWD_TILE - 1, FWD_TILE, FWD_TILE + 1, 132 * FWD_TILE + 17]
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("rows", FWD_ROWS, ids=["1", "63", "64", "65", "tile-1", "tile", "tile+1", "persistent-walk"])
def test_bf16_forward_at_tile_edges(dev, rows, dtype):
    """Row counts around the 128-row tile and past one tile an SM (the
    persistent grid walks on), in both compute types: every row right,
    the ragged tile masked."""
    model = NerfMLP()
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _xT(rows, dev, seed=rows)
    got = mlp.fused_mlp_forward(wts, x, dtype, model)
    torch.cuda.synchronize()
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model)
    assert got.shape == (8, rows) and bool(torch.isfinite(got).all()) and bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]


WIDTH_MODELS = [NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=2, Ld=1, H=256), NerfMLP(Lp=1, Ld=1, H=32),
                NerfMLP(Lp=1, Ld=1, H=256), NerfMLP()]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("model", WIDTH_MODELS, ids=["H16", "H256-small-L", "H32", "H256-L1", "flagship"])
def test_bf16_forward_and_train_step_at_extreme_widths(dev, model, dtype):
    """The narrowest and widest H the kernels take, with the shortest and
    the flagship's encodings, in both compute types: the forward, and B1
    (the forward with its residual planes)."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _xT(1000, dev)
    got = mlp.fused_mlp_forward(wts, x, dtype, model)
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model)
    assert bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]
    x16 = _x16(9, 40, dev)
    loss, grads = mlp.fused_train_step(wts, x16, 40, dtype, model)
    loss_p, grads_p = mlp.fused_train_step_plain(wts, x16, 40, dtype, model)
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(grads, grads_p)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


@pytest.mark.parametrize("rows", [1, 65, 132 * FWD_TILE + 17], ids=["1", "65", "persistent-walk"])
@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=3, Ld=1, H=48)],
                         ids=["flagship", "H16", "odd-widths"])
def test_f32_forward_residual_planes_match_plain(dev, model, rows):
    """The residual planes the f32 forward keeps for B1 and B2 (posx,
    posd, h0..h7, hc), plane by plane against the plain ``_forward``: the
    same f32 products summed in another order, so 2e-4 of the plane's
    largest entry (at least 1); pad rows finite."""
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    x = _xT(rows, dev, seed=rows)
    before = mlp.forward_residuals.launches
    out, res = mlp.forward_residuals(wts, x, torch.float32, model)
    torch.cuda.synchronize()
    assert mlp.forward_residuals.launches == before + 1
    want_out, want = mlp.forward_residuals_plain(wts, x, torch.float32, model)
    assert res.shape == want.shape and bool(torch.isfinite(res).all())
    assert (out[:4] - want_out[:4]).abs().max().item() <= TOL[torch.float32]
    L = mlp.Layout.of(model)
    planes = {"posx": (L.posx, L.FX), "posd": (L.posd, L.FD), "hc": (L.hc, L.H // 2)}
    planes.update({f"h{l}": (L.h(l), L.H) for l in range(8)})
    for name, (f, n) in planes.items():
        g, w_ = res[f : f + n, :rows], want[f : f + n, :rows]
        err = (g - w_).abs().max().item()
        assert err <= 2e-4 * max(1.0, w_.abs().max().item()), (name, err)


def test_bf16_train_step_is_bitwise_deterministic(dev):
    """B1 bf16 over many tiles (more than one an SM): the forward has no
    atomics and the sums reduce in a fixed order, so two runs agree bit
    for bit."""
    model = NerfMLP()
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)),
                            torch.bfloat16)
    x16 = _x16(256, 128, dev, seed=5)
    loss, got = mlp.fused_train_step(wts, x16, 128, torch.bfloat16, model)
    loss2, again = mlp.fused_train_step(wts, x16, 128, torch.bfloat16, model)
    assert loss.item() == loss2.item()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48)], ids=["flagship", "odd-widths"])
def test_weight_image_kernel_matches_plain(dev, model, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    lib = mlp._lib("fused_mlp_fwd")
    bf16 = int(dtype == torch.bfloat16)
    nbytes = lib.fused_mlp_fwd_image_bytes(model.Lp, model.Ld, model.H, bf16)
    image = torch.zeros(nbytes // (2 if bf16 else 4), dtype=torch.int16 if bf16 else torch.float32, device=dev)
    assert lib.fwd_weight_image(mlp._CPtrs(*mlp._ptrs(wts)), model.Lp, model.Ld, model.H, bf16,
                                image.data_ptr(), mlp._stream(image)) == 0
    torch.cuda.synchronize()
    want = mlp.weight_image_plain(wts, model) if bf16 else mlp.f32_weight_image_plain(wts, model)
    assert torch.equal(image, want)


# --- the bf16 backward tile kernel (csrc/bwd_bf16.cuh) -----------------------------

BWD_ROWS = [1, 63, 64, 65, 127, 128, 129, 132 * 128 + 17]  # the last: a persistent walk, not a 64 multiple
EDGE_MODELS = [NerfMLP(), NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=3, Ld=1, H=48)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", BWD_ROWS, ids=[str(r) for r in BWD_ROWS])
@pytest.mark.parametrize("model", EDGE_MODELS, ids=["H256", "H16", "H48"])
def test_backward_tile_matches_plain_at_ragged_rows(dev, model, rows, dtype):
    """The tile kernel alone against backward_tile_plain on random residual
    planes (half zero, as after a relu): every cotangent group within the
    probe's REL_TOL (probes/bwd_tile.py states why), pad rows zero, and two
    runs equal bit for bit."""
    from nerf_simple_tpu_torch.probes import bwd_tile

    wts, res, g = bwd_tile.inputs(model, rows, dev, seed=rows)
    w, res = mlp._cast_weights(wts, dtype), res.to(dtype)
    before, counted = mlp.backward_tile.launches, mlp.bwd_tile_launches()
    got = mlp.backward_tile(w, res, g, dtype, model)
    torch.cuda.synchronize()
    assert mlp.backward_tile.launches == before + 1 and mlp.bwd_tile_launches() == counted + 1
    want = mlp.backward_tile_plain(w, res, g, dtype, model)
    assert got.dtype == dtype and got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    assert not got[:, rows:].any()
    errs = bwd_tile.errors(got, want, model)
    assert max(errs.values()) <= bwd_tile.REL_TOL[dtype], errs
    assert torch.equal(got, mlp.backward_tile(w, res, g, dtype, model))


@pytest.mark.parametrize("model", EDGE_MODELS, ids=["flagship", "H16", "odd-widths"])
def test_bwd_weight_image_kernel_matches_plain(dev, model):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)),
                            torch.bfloat16)
    lib = mlp._lib("fused_mlp_bwd")
    image = torch.zeros(lib.bwd_tile_image_bytes(model.H, 1) // 2, dtype=torch.int16, device=dev)
    assert lib.bwd_weight_image(mlp._CPtrs(*mlp._ptrs(wts)), model.H, image.data_ptr(), mlp._stream(image)) == 0
    torch.cuda.synchronize()
    assert torch.equal(image, mlp.bwd_weight_image_plain(wts, model))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_step_launches_the_tile_kernel_once(dev, dtype):
    model = NerfMLP(Lp=4, Ld=2, H=32)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, dtype, model)
    mlp.bwd_tile_launches(reset=True)
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, dtype, model)
    torch.cuda.synchronize()
    assert mlp.bwd_tile_launches() == 1
