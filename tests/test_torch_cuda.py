"""The CUDA kernels (fused MLP forward, backward, train step with and
without its weights output and its distortion rail, both at once, and
the fused proposal core that launches it so; the cone-cast (mip)
variants of the forward, the backward and the train step, and the
two-level mip core; the pose variants: the forward with the anneal
windows, the backward with the input gradient (``want_dx``), the
input-gradient kernel alone, a pose loss against the xla one; the
appearance variants: the forward, the backward and the input-gradient
kernel with the code rows, an appearance (and pose) loss against the xla
one; render;
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
from nerf_simple_tpu_torch.probes import input_grad as ig_probe

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 64), (NerfMLP(), 41, 64),
                                         (NerfMLP(Lp=4, Ld=2, H=32), 13, 256), (NerfMLP(), 9, 256)],
                         ids=["small-N64", "flagship-N64", "small-N256", "flagship-N256"])
def test_train_step_weights_output_matches_plain(dev, model, B, N, dtype):
    """B1's ``out_weights`` at the hierarchical scheme's N (2 and 8 samples
    a lane of the compositing warp), ragged ray counts: the weights within
    the forward's bound (they are at most 1), loss and gradients as B1's;
    with ``w_out`` null the same launch gives the same loss and gradients
    bit for bit."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    before = mlp.fused_train_step.launches
    loss, got, w = mlp.fused_train_step(wts, x16, N, dtype, model, out_weights=True)
    torch.cuda.synchronize()
    assert mlp.fused_train_step.launches == before + 1
    loss_p, want, w_p = mlp.fused_train_step_plain(wts, x16, N, dtype, model, out_weights=True)
    assert w.shape == (B, N) and bool(torch.isfinite(w).all())
    assert (w - w_p).abs().max().item() <= TOL[dtype]
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    loss0, got0 = mlp.fused_train_step(wts, x16, N, dtype, model)  # w_out null
    assert loss0.item() == loss.item()
    assert all(torch.equal(a, b) for a, b in zip(got, got0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("disparity", [False, True], ids=["linear", "disparity"])
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 64), (NerfMLP(), 41, 128),
                                         (NerfMLP(Lp=4, Ld=2, H=32), 13, 256), (NerfMLP(Lp=3, Ld=1, H=48), 3, 5)],
                         ids=["small-N64", "flagship-N128", "small-N256", "odd-widths-short-rays"])
def test_train_step_distortion_rail_matches_plain(dev, model, B, N, disparity, dtype):
    """B1 with the distortion rail (``dist``) at ragged ray counts and 1 to
    8 samples a lane of the compositing warp, in linear and disparity
    space: loss and gradients within B1's bounds of the plain version; the
    rail adds to the loss; deterministic."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    dist = (0.05, 2.0, 6.0, disparity)
    before = (mlp.fused_train_step.launches, mlp.fused_train_step.dist_launches)
    loss, got = mlp.fused_train_step(wts, x16, N, dtype, model, dist=dist)
    torch.cuda.synchronize()
    assert (mlp.fused_train_step.launches, mlp.fused_train_step.dist_launches) == (before[0] + 1, before[1] + 1)
    loss_p, want = mlp.fused_train_step_plain(wts, x16, N, dtype, model, dist=dist)
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    assert loss.item() > mlp.fused_train_step(wts, x16, N, dtype, model)[0].item()
    loss2, again = mlp.fused_train_step(wts, x16, N, dtype, model, dist=dist)
    assert loss2.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_step_without_the_rail_is_unchanged(dev, dtype):
    """``dist=None`` is the launch without the argument, and the rail at
    weight 0 adds exactly nothing: loss and gradients bit-equal; only
    launches with ``dist`` count in ``dist_launches``; a bad rail raises."""
    model = NerfMLP()
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(40, 128, dev)
    before = mlp.fused_train_step.dist_launches
    loss, got = mlp.fused_train_step(wts, x16, 128, dtype, model)
    runs = [mlp.fused_train_step(wts, x16, 128, dtype, model, dist=None)]
    assert mlp.fused_train_step.dist_launches == before
    runs += [mlp.fused_train_step(wts, x16, 128, dtype, model, dist=(0.0, 2.0, 6.0, d)) for d in (False, True)]
    assert mlp.fused_train_step.dist_launches == before + 2
    for loss0, got0 in runs:
        assert loss0.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, got0))
    for bad in ((0.01, 6.0, 2.0, False), (0.01, 0.0, 6.0, True), (-0.01, 2.0, 6.0, False)):
        with pytest.raises(ValueError, match="dist"):
            mlp.fused_train_step(wts, x16, 128, dtype, model, dist=bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("disparity", [False, True], ids=["linear", "disparity"])
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 64), (NerfMLP(), 41, 128),
                                         (NerfMLP(Lp=3, Ld=1, H=48), 13, 256)],
                         ids=["small-N64", "flagship-N128", "odd-widths-N256"])
def test_train_step_weights_output_with_the_rail_matches_plain(dev, model, B, N, disparity, dtype):
    """B1 with ``out_weights`` and ``dist`` in one launch (the proposal
    scheme's step): weights, loss and gradients within B1's bounds of the
    plain version; the launch counts in ``weights_dist_launches``; without
    the weights output the same launch gives the same loss and gradients
    bit for bit."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    dist = (0.01, 2.0, 6.0, disparity)
    before = (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches)
    loss, got, w = mlp.fused_train_step(wts, x16, N, dtype, model, out_weights=True, dist=dist)
    torch.cuda.synchronize()
    assert (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches) == (before[0] + 1,
                                                                                          before[1] + 1)
    loss_p, want, w_p = mlp.fused_train_step_plain(wts, x16, N, dtype, model, out_weights=True, dist=dist)
    assert w.shape == (B, N) and bool(torch.isfinite(w).all())
    assert (w - w_p).abs().max().item() <= TOL[dtype]
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    loss0, got0 = mlp.fused_train_step(wts, x16, N, dtype, model, dist=dist)
    assert mlp.fused_train_step.weights_dist_launches == before[1] + 1
    assert loss0.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, got0))


def _plain_train_step(wts, x16, N, compute_dtype, model, out_weights=False, dist=None):
    """Stand-in for ``mlp.fused_train_step`` that runs its plain version."""
    with torch.no_grad():
        return mlp.fused_train_step_plain(mlp._cast_weights(wts, compute_dtype), x16, N, compute_dtype, model,
                                          out_weights, dist)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dist", [None, (0.01, 2.0, 6.0, False)], ids=["no-dist", "dist"])
def test_fused_proposal_core_on_the_card(dev, monkeypatch, dist, dtype):
    """The fused proposal core (train/step.py::proposal_fused_loss) with
    the CUDA B1 against the same core with B1's plain version, the same
    probes and samples: loss, both nets' gradients and the main field's
    weights within B1's bounds; one launch, with the weights output and
    (with ``dist``) the rail."""
    from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair, init_proposal_params
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.train import step as step_mod

    model, pm, B, Np, Nf = NerfMLP(Lp=4, Ld=2, H=64), ProposalMLP(Lp=4, D=2, H=32), 64, 16, 32
    params = {"prop": init_proposal_params(0, pm), "fine": init_nerf_params(1, model)}
    rng = np.random.default_rng(2)
    d = rng.normal(size=(B, 3))
    rays = torch.from_numpy(np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True), d], 1)
                            .astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ts_p = stratified_ts(g, B, Np, 2.0, 6.0, dev)
    ts_f = stratified_ts(g, B, Nf, 2.0, 6.0, dev)
    runs = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(step_mod, "fused_train_step", _plain_train_step)
        pair = ProposalPair.from_jax_params(params, dev)
        before = (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches)
        loss, w_f = step_mod.proposal_fused_loss(pair, rays, pix, ts_p, None, Nf, dtype, model, 1.0, dist=dist,
                                                 ts_f=ts_f)
        torch.cuda.synchronize()
        launched = (mlp.fused_train_step.launches - before[0], mlp.fused_train_step.weights_dist_launches - before[1])
        grads = {n: p.grad.clone() for n, p in pair.named_parameters()}
        runs[name] = loss.item(), w_f, grads, launched
    (loss, w, grads, launched), (loss_p, w_p, grads_p, launched_p) = runs["kernel"], runs["plain"]
    assert launched == (1, int(dist is not None)) and launched_p == (0, 0)
    assert (w - w_p).abs().max().item() <= TOL[dtype]
    assert abs(loss / loss_p - 1) <= LOSS_TOL[dtype]
    for n, gp in grads_p.items():
        assert bool(torch.isfinite(grads[n]).all())
        err = ((grads[n] - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        assert err <= GRAD_TOL[dtype], (n, err)


def test_proposal_train_step_on_the_card(dev, tmp_path):
    """One step of the proposal training path: pallas, bf16, the
    distortion rail on; one B1 launch with the weights output and the
    rail; both nets' parameters moved."""
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    cfg = TrainConfig(datapath=str(tmp_path), Nf=32, batch_size=256, backend="pallas", compute_dtype="bf16",
                      net_H=64, net_Lp=4, net_Ld=2, proposal=True, Np=16, prop_Lp=4, prop_D=2, prop_H=32,
                      distortion_loss_weight=0.01)
    model = NerfMLP(Lp=4, Ld=2, H=64)
    state = make_train_state(cfg, model, dev)
    rays = torch.cat([torch.zeros(1000, 3), torch.randn(1000, 3)], 1).to(dev)
    rays[:, :3] = rays[:, 3:] * -4.0
    pixels = torch.rand(1000, 3, device=dev)
    w0 = (state.field.prop.trunk1.weight.detach().clone(), state.field.fine.trunk1.weight.detach().clone())
    before = (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches)
    loss = build_train_step(cfg, model)(state, rays, pixels)
    assert (mlp.fused_train_step.launches, mlp.fused_train_step.weights_dist_launches) == (before[0] + 1,
                                                                                          before[1] + 1)
    assert bool(torch.isfinite(loss)) and state.step == 1
    assert not torch.equal(w0[0], state.field.prop.trunk1.weight)
    assert not torch.equal(w0[1], state.field.fine.trunk1.weight)


# B1 and B2 past 2^31 plane elements, against plain: per tensor, max abs
# error over the plain version's max abs value, chip_smoke.py's bounds at
# the training batch (B2's random cotangents over a million rows cancel,
# so kernel and plain f32 each land ~1e-3 from float64 there).
BIG_GRAD_TOL = {("B1", torch.float32): 1e-4, ("B1", torch.bfloat16): 2e-3,
                ("B2", torch.float32): 1e-2, ("B2", torch.bfloat16): 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_step_and_backward_past_2_31_plane_elements(dev, dtype):
    """The hierarchical fine pass's size: 4096 rays x 256 samples =
    1,048,576 rows, whose residual (2,288 features) and cotangent (2,192)
    planes hold more than 2^31 elements."""
    model, B, N = NerfMLP(), 4096, 256
    rows = B * N
    L = mlp.Layout.of(model)
    assert min(L.FA, L.FG) * rows > 2**31
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16(B, N, dev)
    loss, got = mlp.fused_train_step(wts, x16, N, dtype, model)
    torch.cuda.synchronize()
    loss_p, want = mlp.fused_train_step_plain(wts, x16, N, dtype, model)
    assert abs(loss.item() / loss_p.item() - 1) <= LOSS_TOL[dtype]
    assert max(_grad_errors(got, want).values()) <= BIG_GRAD_TOL["B1", dtype]
    del got, want
    torch.cuda.empty_cache()
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(8, rows)).astype(np.float32)).to(dev)
    xT = x16[:8].contiguous()
    got = mlp.fused_mlp_backward(wts, xT, g, dtype, model)
    torch.cuda.synchronize()
    want = mlp.fused_mlp_backward_plain(wts, xT, g, dtype, model)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert max(_grad_errors(got, want).values()) <= BIG_GRAD_TOL["B2", dtype]
    del got, want
    torch.cuda.empty_cache()


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
@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48), NerfMLP(app_dim=8)],
                         ids=["flagship", "odd-widths", "flagship-app"])
def test_weight_image_kernel_matches_plain(dev, model, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev, model)),
                            dtype)
    lib = mlp._lib("fused_mlp_fwd")
    bf16 = int(dtype == torch.bfloat16)
    nbytes = lib.fused_mlp_fwd_image_bytes(model.Lp, model.Ld, model.H, bf16, mlp._app(model))
    image = torch.zeros(nbytes // (2 if bf16 else 4), dtype=torch.int16 if bf16 else torch.float32, device=dev)
    assert lib.fwd_weight_image(mlp._CPtrs(*mlp._ptrs(wts)), model.Lp, model.Ld, model.H, bf16,
                                image.data_ptr(), mlp._app(model), mlp._stream(image)) == 0
    torch.cuda.synchronize()
    want = mlp.weight_image_plain(wts, model) if bf16 else mlp.f32_weight_image_plain(wts, model)
    assert torch.equal(image, want)


# --- the backward tile kernels (csrc/bwd_f32.cuh, csrc/bwd_bf16.cuh) ---------------

BWD_ROWS = [1, 63, 64, 65, 127, 128, 129, 132 * 128 + 17]  # the last: a persistent walk, not a 64 multiple
# H = 128 and 144: where the f32 kernel's feature groups a thread switch from 1 to 2
EDGE_MODELS = [NerfMLP(), NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=3, Ld=1, H=48), NerfMLP(Lp=2, Ld=1, H=128),
               NerfMLP(Lp=2, Ld=1, H=144)]
EDGE_IDS = ["H256", "H16", "H48", "H128", "H144"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", BWD_ROWS, ids=[str(r) for r in BWD_ROWS])
@pytest.mark.parametrize("model", EDGE_MODELS, ids=EDGE_IDS)
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


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("model", EDGE_MODELS, ids=EDGE_IDS)
def test_bwd_weight_image_kernel_matches_plain(dev, model, dtype):
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    lib = mlp._lib("fused_mlp_bwd")
    bf16 = int(dtype == torch.bfloat16)
    nbytes = lib.bwd_tile_image_bytes(model.H, bf16)
    image = torch.zeros(nbytes // (2 if bf16 else 4), dtype=torch.int16 if bf16 else torch.float32, device=dev)
    assert lib.bwd_weight_image(mlp._CPtrs(*mlp._ptrs(wts)), model.H, bf16, image.data_ptr(),
                                mlp._stream(image)) == 0
    torch.cuda.synchronize()
    want = mlp.bwd_weight_image_plain(wts, model) if bf16 else mlp.f32_bwd_weight_image_plain(wts, model)
    assert torch.equal(image, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_step_launches_the_tile_kernel_once(dev, dtype):
    model = NerfMLP(Lp=4, Ld=2, H=32)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, dtype, model)
    mlp.bwd_tile_launches(reset=True)
    mlp.fused_train_step(wts, _x16(4, 16, dev), 16, dtype, model)
    torch.cuda.synchronize()
    assert mlp.bwd_tile_launches() == 1


# --- the mip (cone-cast) variants ---------------------------------------------

MIP_RADIUS = 0.02  # a cone radius a unit of t: variances to ~2e-3, which damp the high octaves


def _rays_mip(B, dev, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3))
    rays = np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (B, 3)), d], 1)
    return (torch.from_numpy(rays.astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)).to(dev))


def _x16_mip(B, N, dev, seed=0, lw=False):
    """B1's mip input (train/step.py::build_x16_mip) at sorted random
    edges; with ``lw``, loss weights in [0.25, 2] on row 14."""
    from nerf_simple_tpu_torch.train.step import build_x16_mip

    rays, pix = _rays_mip(B, dev, seed)
    edges = torch.from_numpy(np.sort(np.random.default_rng(seed + 1).uniform(2, 6, (B, N + 1)), -1)
                             .astype(np.float32)).to(dev)
    x = build_x16_mip(rays, edges, pix, MIP_RADIUS)
    if lw:
        w = torch.from_numpy(np.random.default_rng(seed + 2).uniform(0.25, 2.0, B).astype(np.float32)).to(dev)
        x[14] = w.repeat_interleave(N)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", CASES, ids=CASE_IDS)
def test_forward_mip_matches_plain(dev, model, rows, dtype):
    """The forward with the integrated encoder (``mip=True``: 16 input
    rows, variances in rows 11..13) against its plain version at ragged
    rows; it counts in ``mip_launches``; at zero variance it is the point
    forward bit for bit (each damp factor is exactly 1)."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    B = -(-rows // 8)
    x = _x16_mip(B, 8, dev)[:, :rows].contiguous()
    before = (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.mip_launches)
    got = mlp.fused_mlp_forward(wts, x, dtype, model, mip=True)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.mip_launches) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model, mip=True)
    assert bool(torch.isfinite(got).all()) and bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]
    point = mlp.fused_mlp_forward(wts, x[:8].contiguous(), dtype, model)
    assert not torch.equal(got, point)  # the variances damp
    x0 = x.clone()
    x0[11:14] = 0.0
    assert torch.equal(mlp.fused_mlp_forward(wts, x0, dtype, model, mip=True), point)
    with pytest.raises(ValueError, match="16"):
        mlp.fused_mlp_forward(wts, x[:8].contiguous(), dtype, model, mip=True)


@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48)], ids=["flagship", "odd-widths"])
def test_f32_forward_mip_residual_planes_match_plain(dev, model):
    """The f32 forward keeps the damped encoding in posx's residual plane,
    which B1's and B2's weight gradients read: every plane against the
    plain ``_forward`` with mip."""
    rows = 132 * FWD_TILE + 17
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    x = _x16_mip(-(-rows // 8), 8, dev, seed=3)[:, :rows].contiguous()
    out, res = mlp.forward_residuals(wts, x, torch.float32, model, mip=True)
    torch.cuda.synchronize()
    want_out, want = mlp.forward_residuals_plain(wts, x, torch.float32, model, mip=True)
    assert (out[:4] - want_out[:4]).abs().max().item() <= TOL[torch.float32]
    err = (res[:, :rows] - want[:, :rows]).abs().max().item()
    assert err <= 2e-4 * max(1.0, want[:, :rows].abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", CASES, ids=CASE_IDS)
def test_backward_mip_matches_plain(dev, model, rows, dtype):
    """B2 recomputing the forward with the integrated encoder (``mip``)
    against its plain version; it counts in ``mip_launches``."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _x16_mip(-(-rows // 8), 8, dev, seed=4)[:, :rows].contiguous()
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(8, rows)).astype(np.float32)).to(dev)
    before = (mlp.fused_mlp_backward.launches, mlp.fused_mlp_backward.mip_launches)
    got = mlp.fused_mlp_backward(wts, x, g, dtype, model, mip=True)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_backward.launches, mlp.fused_mlp_backward.mip_launches) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_mlp_backward_plain(wts, x, g, dtype, model, mip=True)
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


MIP_CASES = {"plain": dict(), "weights": dict(out_weights=True), "opaque": dict(opaque_tail=True),
             "rail": dict(dist=(0.05, 2.0, 6.0, False), lw=True),
             "rail-opaque-disparity": dict(dist=(0.05, 2.0, 6.0, True), opaque_tail=True, lw=True, out_weights=True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(MIP_CASES))
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 64), (NerfMLP(), 41, 128),
                                         (NerfMLP(Lp=3, Ld=1, H=48), 3, 5)],
                         ids=["small-N64", "flagship-N128", "odd-widths-short-rays"])
def test_train_step_mip_matches_plain(dev, model, B, N, case, dtype):
    """B1's cone-cast variant (the integrated encoder, interval
    compositing, the per-ray loss weight of row 14, the opaque tail, the
    interval rail, the weights output) at ragged ray counts against its
    plain version: loss, gradients and weights within B1's bounds; the
    launch counts in ``mip_launches`` (and ``opaque_launches``);
    deterministic."""
    kw = dict(MIP_CASES[case])
    x16 = _x16_mip(B, N, dev, seed=5, lw=kw.pop("lw", False))
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    counts = ("launches", "mip_launches", "opaque_launches")
    before = [getattr(mlp.fused_train_step, c) for c in counts]
    out = mlp.fused_train_step(wts, x16, N, dtype, model, mip=True, **kw)
    torch.cuda.synchronize()
    assert [getattr(mlp.fused_train_step, c) - b for c, b in zip(counts, before)] == [
        1, 1, int(kw.get("opaque_tail", False))]
    want = mlp.fused_train_step_plain(wts, x16, N, dtype, model, mip=True, **kw)
    assert abs(out[0].item() / want[0].item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(out[1], want[1])
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    if kw.get("out_weights"):
        assert out[2].shape == (B, N) and (out[2] - want[2]).abs().max().item() <= TOL[dtype]
    again = mlp.fused_train_step(wts, x16, N, dtype, model, mip=True, **kw)
    assert again[0].item() == out[0].item() and all(torch.equal(a, b) for a, b in zip(out[1], again[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_level_mip_core_on_the_card(dev, monkeypatch, dtype):
    """The fused two-level mip core (train/step.py::mip_fused_loss) with
    the CUDA B1 against the same core with B1's plain version, the same
    edges and fine edges: loss and gradients within B1's bounds; two
    launches, both cone-cast, one with the weights output; then one step
    of the mip training path (pallas, bf16, mip_levels 2)."""
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.train import step as step_mod

    model, B, N = NerfMLP(Lp=4, Ld=2, H=64), 64, 32
    params = init_nerf_params(1, model)
    rays, pix = _rays_mip(B, dev, 6)
    rng = np.random.default_rng(7)
    edges, edges_f = (torch.from_numpy(np.sort(rng.uniform(2, 6, (B, N + 1)), -1).astype(np.float32)).to(dev)
                      for _ in range(2))

    def plain(wts, x16, N, compute_dtype, model, out_weights=False, dist=None, mip=False, opaque_tail=False):
        with torch.no_grad():
            return mlp.fused_train_step_plain(mlp._cast_weights(wts, compute_dtype), x16, N, compute_dtype, model,
                                              out_weights, dist, mip, opaque_tail)

    runs = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(step_mod, "fused_train_step", plain)
        field = NerfField.from_jax_params(params, dev)
        counts = ("launches", "mip_launches", "weights_launches")
        before = [getattr(mlp.fused_train_step, c) for c in counts]
        loss = step_mod.mip_fused_loss(field, rays, pix, edges, None, dtype, model, MIP_RADIUS, mip_levels=2,
                                       edges_fine=edges_f)
        torch.cuda.synchronize()
        runs[name] = (loss.item(), {n: p.grad.clone() for n, p in field.named_parameters()},
                      [getattr(mlp.fused_train_step, c) - b for c, b in zip(counts, before)])
    monkeypatch.undo()
    (loss, grads, launched), (loss_p, grads_p, launched_p) = runs["kernel"], runs["plain"]
    assert launched == [2, 2, 1] and launched_p == [0, 0, 0]
    assert abs(loss / loss_p - 1) <= LOSS_TOL[dtype]
    for n, gp in grads_p.items():
        err = ((grads[n] - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        assert err <= GRAD_TOL[dtype], (n, err)
    cfg = TrainConfig(datapath="d", Nf=N, batch_size=256, backend="pallas", compute_dtype="bf16", net_H=64,
                      net_Lp=4, net_Ld=2, mip=True, mip_levels=2)
    state = step_mod.make_train_state(cfg, model, dev)
    all_rays = _rays_mip(1000, dev, 8)[0]
    w0 = state.field.trunk1.weight.detach().clone()
    before = mlp.fused_train_step.mip_launches
    out = step_mod.build_train_step(cfg, model, base_radius=MIP_RADIUS)(state, all_rays, torch.rand(1000, 3, device=dev))
    assert mlp.fused_train_step.mip_launches == before + 2
    assert bool(torch.isfinite(out)) and not torch.equal(w0, state.field.trunk1.weight)


# --- pose refinement: the anneal windows and the input gradient (B2's want_dx) ---------------

# dx against plain, over max |dx|: both sum the same operands (bf16 values
# are exact in f32) in f32 in another order; the transpose scales octave i
# by 2^i, so those ulps reach dx unevenly (probes/input_grad.py's bounds).
DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
# B2's dx against plain also carries B2's own forward, whose relu masks
# can differ from the plain chain's where a pre-activation lies within the
# forward's rounding of 0; that row's dx then moves by a whole term (bf16
# at the flagship: 0.032 of max |dx| at a row). So B2's dx must equal the
# input-gradient kernel on the kernels' own planes bit for bit, every row
# past DX_TOL from plain (the position and direction rows each against
# their own largest entry) must have a flipped mask, the plain chain on the
# kernel's own masks must give B2's dx within DX_TOL at every row
# (probes/input_grad.py::explain_dx), and under DX_ROW_SHARE of the rows
# may lie past DX_TOL.
# DX_ROW_SHARE: the most rows past DX_TOL measured in a sound run, with
# room (f32 3.05e-5 at 524,288 rows, none in the card tests; bf16 1.46e-3
# at 4,113 rows, 5.7e-4 at 524,288), far below the least share a planted
# fault puts past it (0.66, bf16 at 524,288 rows).
DX_ROW_SHARE = {torch.float32: 1e-4, torch.bfloat16: 3e-3}
POSE_CASES = [(NerfMLP(Lp=4, Ld=2, H=32), 1000), (NerfMLP(Lp=3, Ld=1, H=48), 65), (NerfMLP(), 4096 + 17),
              (NerfMLP(), 63), (NerfMLP(Lp=10, Ld=4, H=64), 1)]
POSE_IDS = ["small-ragged", "odd-widths-65", "flagship-ragged", "flagship-63", "H64-1"]


def _dx_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("alpha", [0.3, 1.0], ids=["a0.3", "a1"])
@pytest.mark.parametrize("model, rows", CASES, ids=CASE_IDS)
def test_forward_anneal_matches_plain(dev, model, rows, alpha, dtype):
    """The forward with BARF's anneal windows (``enc_w``) against its plain
    version at ragged rows; it counts in ``anneal_launches``; at alpha 1
    (every window exactly 1) it is the forward without windows bit for
    bit, as is the f32 one's residual posx plane."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _xT(rows, dev, seed=5)
    enc_w = mlp.anneal_row_weights(model, alpha, dev)
    before = (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.anneal_launches)
    got = mlp.fused_mlp_forward(wts, x, dtype, model, enc_w=enc_w)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.anneal_launches) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model, enc_w=enc_w)
    assert bool(torch.isfinite(got).all()) and bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]
    plain = mlp.fused_mlp_forward(wts, x, dtype, model)
    assert torch.equal(got, plain) == (alpha == 1.0)
    if alpha == 1.0:
        _, res_w = mlp.forward_residuals(wts, x, dtype, model, enc_w=enc_w)
        _, res = mlp.forward_residuals(wts, x, dtype, model)
        assert torch.equal(res_w, res)
    with pytest.raises(ValueError, match="enc_w"):
        mlp.fused_mlp_forward(wts, x, dtype, model, enc_w=(enc_w[0][:-1].contiguous(), enc_w[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("windows", [False, True], ids=["no-windows", "a0.3"])
@pytest.mark.parametrize("model, rows", POSE_CASES, ids=POSE_IDS)
def test_input_grad_kernel_matches_plain(dev, model, rows, windows, dtype):
    """The input-gradient kernel alone (``input_grad``) against
    ``input_grad_plain`` on the backward tile kernel's cotangent planes of
    random output cotangents, at ragged row counts (rows not a multiple of
    64, one row): ``dx`` within DX_TOL of max |dx|, rows 6..7 zero, the
    launch counted by the wrapper and in C."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(2, model), dev)), dtype)
    x = _xT(rows, dev, seed=6)
    enc_w = mlp.anneal_row_weights(model, 0.3, dev) if windows else None
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(8, rows)).astype(np.float32)).to(dev)
    _, res = mlp.forward_residuals(wts, x, dtype, model, enc_w=enc_w)
    gws = mlp.backward_tile(wts, res, g, dtype, model)
    before = (mlp.input_grad.launches, mlp.input_grad_launches())
    got = mlp.input_grad(wts, x, gws, dtype, model, enc_w)
    torch.cuda.synchronize()
    assert (mlp.input_grad.launches, mlp.input_grad_launches()) == (before[0] + 1, before[1] + 1)
    want = mlp.input_grad_plain(wts, x, gws, dtype, model, enc_w)
    assert got.shape == (8, rows) and bool(torch.isfinite(got).all()) and bool((got[6:] == 0).all())
    assert _dx_err(got, want) <= DX_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("windows", [False, True], ids=["no-windows", "a0.3"])
@pytest.mark.parametrize("model, rows", CASES, ids=CASE_IDS)
def test_backward_want_dx_matches_plain(dev, model, rows, windows, dtype):
    """B2 with ``want_dx`` (and the anneal windows in its recompute)
    against its plain version: the weight gradients within B2's bounds,
    ``dx`` bit-equal to the input-gradient kernel on the planes of the
    forward and backward tile kernels, every row past DX_TOL from plain
    explained by a flipped relu mask, within DX_TOL of the plain chain on
    the kernel's own masks, and under DX_ROW_SHARE of its rows past
    DX_TOL; two planted faults (an octave window halved) caught by the
    same rule; the weight gradients bit-equal to the same launch without
    ``want_dx`` (the input gradient runs after them); the counters
    ``dx_launches``, ``anneal_launches`` and the C count."""
    from nerf_simple_tpu_torch.probes.input_grad import explain_dx

    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _xT(rows, dev, seed=8)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(8, rows)).astype(np.float32)).to(dev)
    enc_w = mlp.anneal_row_weights(model, 0.3, dev) if windows else None
    b = mlp.fused_mlp_backward
    before = (b.launches, b.dx_launches, b.anneal_launches, mlp.input_grad_launches())
    got, dx = b(wts, x, g, dtype, model, want_dx=True, enc_w=enc_w)
    torch.cuda.synchronize()
    assert (b.launches, b.dx_launches, b.anneal_launches, mlp.input_grad_launches()) == (
        before[0] + 1, before[1] + 1, before[2] + windows, before[3] + 1)
    want, dx_p = mlp.fused_mlp_backward_plain(wts, x, g, dtype, model, want_dx=True, enc_w=enc_w)
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    _, res = mlp.forward_residuals(wts, x, dtype, model, enc_w=enc_w)
    assert torch.equal(dx, mlp.input_grad(wts, x, mlp.backward_tile(wts, res, g, dtype, model), dtype, model, enc_w))
    ex = explain_dx(wts, x, g, dx, dx_p, dtype, model, enc_w, DX_TOL[dtype])
    print(f"dx rows: {ex}")
    assert ex["n_unexplained"] == 0 and ex["own_masks_err"] <= DX_TOL[dtype], ex
    assert ex["share"] <= DX_ROW_SHARE[dtype], ex
    assert all(f["n_unexplained"] > 0 for f in ex["faults"].values()), ex
    alone = b(wts, x, g, dtype, model, enc_w=enc_w)
    assert all(torch.equal(a, c) for a, c in zip(got, alone))
    # under mip B2 launches the input gradient's mip instantiation: 16 rows (held below)
    _, dx16 = b(wts, _x16_mip(-(-rows // 8), 8, dev)[:, :rows].contiguous(), g, dtype, model, mip=True, want_dx=True)
    assert dx16.shape == (16, rows)


def test_fused_mlp_gives_xT_its_gradient(dev):
    """The differentiable ``fused_mlp`` on an xT that needs a gradient:
    autograd gets ``dx`` from B2 (one launch with the input gradient) and
    carries it through the unit-direction normalisation to the rays; an
    xT that needs none gets none, and B2 runs without ``want_dx``."""
    model, rows = NerfMLP(Lp=4, Ld=2, H=32), 512
    field = NerfField.from_jax_params(init_nerf_params(3, model), dev)
    base = _xT(rows, dev, seed=10)
    g = torch.from_numpy(np.random.default_rng(11).normal(size=(8, rows)).astype(np.float32)).to(dev)
    for needs in (True, False):
        xT = base.clone().requires_grad_(needs)
        before = mlp.fused_mlp_backward.dx_launches
        out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), xT, torch.float32, model)
        (out * g).sum().backward()
        assert mlp.fused_mlp_backward.dx_launches == before + needs
        if needs:
            want = mlp.fused_mlp_backward_plain(mlp.pack_weights(field), base, g, torch.float32, model,
                                                want_dx=True)[1]
            assert _dx_err(xT.grad, want) <= DX_TOL[torch.float32]
        else:
            assert xT.grad is None


def test_pose_step_on_the_card_matches_xla(dev):
    """One f32 pose loss from one state (``autograd_loss`` with the camera
    deltas of each ray's image, the anneal at alpha 0.4) through the
    forward kernel and B2 with the input gradient and the windows, against
    the same loss on the xla backend: the loss to LOSS_TOL, the gradients
    of the field and of the dr/dt tables within 1e-3 of each one's largest
    entry (f32 sums in other orders over the batch); then one pallas pose
    step through ``build_train_step`` moves the deltas past the warmup."""
    import dataclasses

    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.train.step import (CamDeltas, autograd_loss, build_train_step, make_train_state,
                                                  render_settings)

    model, n_img, hw, B, N = NerfMLP(Lp=6, Ld=3, H=64), 4, 256, 512, 32
    cfg = TrainConfig(datapath="d", Nf=N, batch_size=B, backend="pallas", compute_dtype="f32", net_H=64, net_Lp=6,
                      net_Ld=3, pose_opt=True, pose_warmup=0, pe_anneal_until=10)
    rng = np.random.default_rng(12)
    d = rng.normal(size=(n_img * hw, 3))
    rays = torch.from_numpy(np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True), d], 1)
                            .astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (n_img * hw, 3)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, n_img * hw, B)).to(dev)
    ts = torch.from_numpy(np.sort(rng.uniform(2, 6, (B, N)), -1).astype(np.float32)).to(dev)
    tables = {k: rng.normal(0, 0.02, (n_img, 3)).astype(np.float32) for k in ("dr", "dt")}
    got = {}
    for backend in ("pallas", "xla"):
        field = NerfField.from_jax_params(init_nerf_params(4, model), dev)
        cams = CamDeltas(n_img, dev).copy_tables_(tables)
        c = dataclasses.replace(cfg, backend=backend)
        before = mlp.fused_mlp_backward.dx_launches
        loss = autograd_loss(c, field, rays[idx], pix[idx], ts, None, render_settings(c), cams=cams,
                             im_b=idx // hw, enc_alpha=0.4)
        loss.backward()
        torch.cuda.synchronize()
        assert mlp.fused_mlp_backward.dx_launches == before + (backend == "pallas")
        got[backend] = (loss.item(), [p.grad for p in field.parameters()], [cams.dr.grad, cams.dt.grad])
    (lp, fp, cp), (lx, fx, cx) = got["pallas"], got["xla"]
    assert abs(lp / lx - 1) <= LOSS_TOL[torch.float32]
    for a, b in zip(fp + cp, fx + cx):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3
    state = make_train_state(cfg, model, dev, n_images=n_img)
    out = build_train_step(cfg, model, rays_per_image=hw)(state, rays, pix)
    assert bool(torch.isfinite(out)) and float(state.cams.dr.detach().abs().max()) > 0


# --- appearance codes: the code rows of the forward, B2 and the input gradient ---------------

APP_CASES = [(NerfMLP(Lp=4, Ld=2, H=32, app_dim=3), 1000), (NerfMLP(Lp=3, Ld=1, H=48, app_dim=8), 65),
             (NerfMLP(app_dim=8), 4096 + 17), (NerfMLP(Lp=10, Ld=4, H=64, app_dim=5), 1)]
APP_IDS = ["small-ragged", "odd-widths-65", "flagship-ragged", "H64-1"]


def _x16_app(model, rows, dev, seed):
    """An appearance model's kernel input: xyz and unit dirs as ``_xT``,
    each row's code (app_dim rows from N(0, 0.5)) in rows 8..15, zero
    after."""
    x = torch.zeros((16, rows), dtype=torch.float32, device=dev)
    x[:8] = _xT(rows, dev, seed)
    codes = np.random.default_rng(seed + 100).normal(0, 0.5, (model.app_dim, rows)).astype(np.float32)
    x[8 : 8 + model.app_dim] = torch.from_numpy(codes).to(dev)
    return x


def _without_codes(model, dev, seed):
    """(the appearance model's field, the model without codes, its field
    with the same weights but color0's code columns)."""
    import dataclasses

    params = init_nerf_params(seed, model)
    plain_model = dataclasses.replace(model, app_dim=0)
    H, Cd = model.H, plain_model.in_Cd
    cut = {**params, "color0": {"w": params["color0"]["w"][: H + Cd], "b": params["color0"]["b"]}}
    return (NerfField.from_jax_params(params, dev, model), plain_model,
            NerfField.from_jax_params(cut, dev, plain_model))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", APP_CASES, ids=APP_IDS)
def test_forward_with_codes_matches_plain(dev, model, rows, dtype):
    """The forward with the code rows against its plain version at ragged
    rows, counted in ``app_launches``; its residual posd plane ends with the
    codes (rounded to the compute type); other codes move the colour, never
    sigma (bit for bit); zero codes give the model without codes (color0's
    code columns cut) bit for bit: the fold adds nothing else."""
    field, plain_model, plain_field = _without_codes(model, dev, 0)
    wts = mlp._cast_weights(mlp.pack_weights(field), dtype)
    x = _x16_app(model, rows, dev, 5)
    f = mlp.fused_mlp_forward
    before = (f.launches, f.app_launches)
    got = f(wts, x, dtype, model)
    torch.cuda.synchronize()
    assert (f.launches, f.app_launches) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, model)
    assert bool(torch.isfinite(got).all()) and bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]
    x2 = x.clone()
    x2[8 : 8 + model.app_dim] += 1.0
    other = f(wts, x2, dtype, model)
    assert torch.equal(other[3], got[3]) and (other[:3] - got[:3]).abs().max().item() > 1e-3
    _, res = mlp.forward_residuals(wts, x, dtype, model)
    L, FD0 = mlp.Layout.of(model), mlp._enc_rows(model.Ld)
    assert torch.equal(res[L.posd + FD0 : L.posd + FD0 + 8, :rows].float(), x[8:16].to(dtype).float())
    x0 = x.clone()
    x0[8:] = 0
    zero = f(wts, x0, dtype, model)
    no_codes = f(mlp._cast_weights(mlp.pack_weights(plain_field), dtype), x0[:8].contiguous(), dtype, plain_model)
    assert torch.equal(zero, no_codes)
    with pytest.raises(ValueError, match="rows 8..15"):
        f(wts, x, dtype, model, mip=True)
    with pytest.raises(ValueError, match="xT must be"):
        f(wts, x[:8].contiguous(), dtype, model)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("windows", [False, True], ids=["no-windows", "a0.3"])
@pytest.mark.parametrize("model, rows", APP_CASES[:3], ids=APP_IDS[:3])
def test_backward_with_codes_matches_plain(dev, model, rows, windows, dtype):
    """B2 with ``want_dx`` on an appearance model (the recompute with the
    codes, ``dWca`` in ``Wcd``'s last eight columns, the codes' rows of
    dx) against its plain version: the weight gradients within B2's
    bounds; dx (16 rows) bit-equal to the input-gradient kernel on the
    forward and backward tile kernels' planes; held row by row as the pose
    dx is (``explain_dx``, the code rows against their own largest entry,
    a planted fault in them caught); rows 6..7 and the pad code rows zero;
    the weight gradients bit-equal to the launch without ``want_dx``; the
    counters ``app_launches``, ``dx_launches`` and the C count."""
    from nerf_simple_tpu_torch.probes.input_grad import explain_dx

    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev, model)),
                            dtype)
    x = _x16_app(model, rows, dev, 8)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(8, rows)).astype(np.float32)).to(dev)
    enc_w = mlp.anneal_row_weights(model, 0.3, dev) if windows else None
    b = mlp.fused_mlp_backward
    before = (b.launches, b.app_launches, b.dx_launches, mlp.input_grad_launches())
    got, dx = b(wts, x, g, dtype, model, want_dx=True, enc_w=enc_w)
    torch.cuda.synchronize()
    assert (b.launches, b.app_launches, b.dx_launches, mlp.input_grad_launches()) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1)
    want, dx_p = mlp.fused_mlp_backward_plain(wts, x, g, dtype, model, want_dx=True, enc_w=enc_w)
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    FD0 = mlp._enc_rows(model.Ld)
    dwca = ((got.Wcd[:, FD0:] - want.Wcd[:, FD0:]).abs().max() / want.Wcd[:, FD0:].abs().max()).item()
    assert dwca <= GRAD_TOL[dtype], dwca
    assert dx.shape == (16, rows) and bool((dx[6:8] == 0).all()) and bool((dx[8 + model.app_dim :] == 0).all())
    _, res = mlp.forward_residuals(wts, x, dtype, model, enc_w=enc_w)
    assert torch.equal(dx, mlp.input_grad(wts, x, mlp.backward_tile(wts, res, g, dtype, model), dtype, model, enc_w))
    ex = explain_dx(wts, x, g, dx, dx_p, dtype, model, enc_w, DX_TOL[dtype])
    print(f"dx rows: {ex}")
    assert ex["n_unexplained"] == 0 and ex["own_masks_err"] <= DX_TOL[dtype], ex
    assert ex["share"] <= DX_ROW_SHARE[dtype], ex
    assert all(f["n_unexplained"] > 0 for f in ex["faults"].values()) and "code_rows_half" in ex["faults"], ex
    alone = b(wts, x, g, dtype, model, enc_w=enc_w)
    assert all(torch.equal(a, c) for a, c in zip(got, alone))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", APP_CASES, ids=APP_IDS)
def test_input_grad_kernel_with_codes_matches_plain(dev, model, rows, dtype):
    """The input-gradient kernel alone on an appearance model's planes
    against ``input_grad_plain``: dx (16 rows) within DX_TOL of max |dx|,
    the code rows within DX_TOL of their own largest entry, rows 6..7
    zero, counted in ``input_grad.app_launches``; its rows 0..5 bit-equal
    to the kernel's on the same planes laid out without the code rows."""
    import dataclasses

    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(2, model), dev, model)),
                            dtype)
    x = _x16_app(model, rows, dev, 6)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(8, rows)).astype(np.float32)).to(dev)
    _, res = mlp.forward_residuals(wts, x, dtype, model)
    gws = mlp.backward_tile(wts, res, g, dtype, model)
    before = (mlp.input_grad.launches, mlp.input_grad.app_launches)
    got = mlp.input_grad(wts, x, gws, dtype, model)
    torch.cuda.synchronize()
    assert (mlp.input_grad.launches, mlp.input_grad.app_launches) == (before[0] + 1, before[1] + 1)
    want = mlp.input_grad_plain(wts, x, gws, dtype, model)
    assert got.shape == (16, rows) and bool(torch.isfinite(got).all()) and bool((got[6:8] == 0).all())
    assert _dx_err(got, want) <= DX_TOL[dtype]
    assert _dx_err(got[8:], want[8:]) <= DX_TOL[dtype]
    plain_model = dataclasses.replace(model, app_dim=0)
    FD0 = mlp._enc_rows(model.Ld)
    w0 = wts._replace(Wcd=wts.Wcd[:, :FD0].contiguous())
    L, L0 = mlp.Layout.of(model), mlp.Layout.of(plain_model)
    assert L.FG == L0.FG  # the cotangent planes do not move
    no_codes = mlp.input_grad(w0, x[:8].contiguous(), gws, dtype, plain_model)
    assert torch.equal(got[:8], no_codes)


def test_appearance_step_on_the_card_matches_xla(dev):
    """One f32 loss from one state with appearance codes and the camera
    deltas of each ray's image (``autograd_loss``, the anneal at alpha
    0.4) through the forward kernel and B2 with the code rows and the
    input gradient, against the same loss on the xla backend: the loss to
    LOSS_TOL, the gradients of the field, of the code table and of the
    dr/dt tables within 1e-3 of each one's largest entry; then one pallas
    step through ``build_train_step`` moves the codes (and the deltas)."""
    import dataclasses

    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.train.step import (AppCodes, CamDeltas, autograd_loss, build_train_step,
                                                  make_train_state, render_settings)

    model, n_img, hw, B, N = NerfMLP(Lp=6, Ld=3, H=64, app_dim=8), 4, 256, 512, 32
    cfg = TrainConfig(datapath="d", Nf=N, batch_size=B, backend="pallas", compute_dtype="f32", net_H=64, net_Lp=6,
                      net_Ld=3, pose_opt=True, pose_warmup=0, pe_anneal_until=10, appearance_dim=8)
    rng = np.random.default_rng(13)
    d = rng.normal(size=(n_img * hw, 3))
    rays = torch.from_numpy(np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True), d], 1)
                            .astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (n_img * hw, 3)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, n_img * hw, B)).to(dev)
    ts = torch.from_numpy(np.sort(rng.uniform(2, 6, (B, N)), -1).astype(np.float32)).to(dev)
    tables = {k: rng.normal(0, 0.02, (n_img, 3)).astype(np.float32) for k in ("dr", "dt")}
    codes = rng.normal(0, 0.3, (n_img, 8)).astype(np.float32)
    got = {}
    for backend in ("pallas", "xla"):
        field = NerfField.from_jax_params(init_nerf_params(4, model), dev, model)
        cams = CamDeltas(n_img, dev).copy_tables_(tables)
        app = AppCodes(n_img, 8, dev).copy_tables_(codes)
        c = dataclasses.replace(cfg, backend=backend)
        before = (mlp.fused_mlp_backward.dx_launches, mlp.fused_mlp_backward.app_launches)
        loss = autograd_loss(c, field, rays[idx], pix[idx], ts, None, render_settings(c), cams=cams,
                             im_b=idx // hw, enc_alpha=0.4, app=app)
        loss.backward()
        torch.cuda.synchronize()
        assert (mlp.fused_mlp_backward.dx_launches, mlp.fused_mlp_backward.app_launches) == (
            before[0] + (backend == "pallas"), before[1] + (backend == "pallas"))
        got[backend] = (loss.item(), [p.grad for p in field.parameters()], [cams.dr.grad, cams.dt.grad, app.table.grad])
    (lp, fp, cp), (lx, fx, cx) = got["pallas"], got["xla"]
    assert abs(lp / lx - 1) <= LOSS_TOL[torch.float32]
    for a, b in zip(fp + cp, fx + cx):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3
    state = make_train_state(cfg, model, dev, n_images=n_img)
    out = build_train_step(cfg, model, rays_per_image=hw)(state, rays, pix)
    assert bool(torch.isfinite(out)) and float(state.app.table.detach().abs().max()) > 0
    assert float(state.cams.dr.detach().abs().max()) > 0


# --- pose refinement with mip: the input gradient's mip instantiation -----------------------------

def _x16_pose_mip(rows, dev, seed):
    """The mip kernels' input for the input gradient: means uniform in
    [-4, 4], unit dirs, variances log-uniform in [1e-6, 1e-2] in rows
    11..13 (the damp of the top octaves from ~1 to ~0); other rows zero."""
    return ig_probe.inputs(NerfMLP(), rows, dev, seed=seed, mip=True)[2]


MIP_ZERO_ROWS = list(ig_probe.MIP_ZERO_ROWS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", POSE_CASES, ids=POSE_IDS)
def test_input_grad_kernel_mip_matches_plain(dev, model, rows, dtype):
    """The input-gradient kernel's mip instantiation alone (``input_grad(mip=
    True)``) against ``input_grad_plain(mip=True)`` on the backward tile
    kernel's planes, at ragged row counts: every row group (means, dirs,
    variances) within DX_TOL of its own largest entry, the rows JAX leaves
    zero exactly zero; two planted faults (the damp dropped, the variance
    rows halved) lie past DX_TOL by the same measure; the launch counted by
    the wrapper and in C. At zero variance its rows 0..5 are the point
    launch's on the same planes bit for bit (damp exactly 1)."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(2, model), dev)), dtype)
    x = _x16_pose_mip(rows, dev, seed=6)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(8, rows)).astype(np.float32)).to(dev)
    _, res = mlp.forward_residuals(wts, x, dtype, model, mip=True)
    gws = mlp.backward_tile(wts, res, g, dtype, model)
    before = (mlp.input_grad.launches, mlp.input_grad.mip_launches, mlp.input_grad_launches(),
              mlp.input_grad_mip_launches())
    got = mlp.input_grad(wts, x, gws, dtype, model, mip=True)
    torch.cuda.synchronize()
    assert (mlp.input_grad.launches, mlp.input_grad.mip_launches, mlp.input_grad_launches(),
            mlp.input_grad_mip_launches()) == tuple(n + 1 for n in before)
    want = mlp.input_grad_plain(wts, x, gws, dtype, model, mip=True)
    assert got.shape == (16, rows) and bool(torch.isfinite(got).all()) and bool((got[MIP_ZERO_ROWS] == 0).all())
    assert ig_probe.row_err(got, want, mip=True).max().item() <= DX_TOL[dtype]
    x0 = x.clone()
    x0[11:14] = 0.0
    bad = {"damp_dropped": mlp.input_grad_plain(wts, x0, gws, dtype, model, mip=True), "variance_rows_half": want.clone()}
    bad["variance_rows_half"][11:14] *= 0.5
    for name, b in bad.items():
        assert ig_probe.row_err(b, want, mip=True).max().item() > DX_TOL[dtype], name
    at0 = mlp.input_grad(wts, x0, gws, dtype, model, mip=True)
    point = mlp.input_grad(wts, x0[:8].contiguous(), gws, dtype, model)
    assert torch.equal(at0[:6], point[:6]) and bool((at0[MIP_ZERO_ROWS] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model, rows", POSE_CASES, ids=POSE_IDS)
def test_backward_mip_want_dx_matches_plain(dev, model, rows, dtype):
    """B2 with ``mip`` and ``want_dx`` against its plain version by
    ``explain_dx``'s rule (mip: the mean, direction and variance rows each
    against their own largest entry): the weight gradients within B2's
    bounds and bit-equal to B2 with mip and without dx, dx bit-equal to the
    mip input-gradient kernel on the tile kernels' planes, every row past
    DX_TOL from plain explained by a flipped relu mask, within DX_TOL of the
    plain chain on the kernel's own masks, under DX_ROW_SHARE past DX_TOL;
    both planted faults caught; the counters ``mip_dx_launches`` and the C
    count."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x = _x16_pose_mip(rows, dev, seed=8)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(8, rows)).astype(np.float32)).to(dev)
    b = mlp.fused_mlp_backward
    before = (b.launches, b.mip_launches, b.dx_launches, b.mip_dx_launches, mlp.input_grad_mip_launches())
    got, dx = b(wts, x, g, dtype, model, mip=True, want_dx=True)
    torch.cuda.synchronize()
    assert (b.launches, b.mip_launches, b.dx_launches, b.mip_dx_launches,
            mlp.input_grad_mip_launches()) == tuple(n + 1 for n in before)
    want, dx_p = mlp.fused_mlp_backward_plain(wts, x, g, dtype, model, mip=True, want_dx=True)
    errs = _grad_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    assert dx.shape == (16, rows) and bool((dx[MIP_ZERO_ROWS] == 0).all())
    _, res = mlp.forward_residuals(wts, x, dtype, model, mip=True)
    assert torch.equal(dx, mlp.input_grad(wts, x, mlp.backward_tile(wts, res, g, dtype, model), dtype, model, mip=True))
    ex = ig_probe.explain_dx(wts, x, g, dx, dx_p, dtype, model, None, DX_TOL[dtype], mip=True)
    print(f"mip dx rows: {ex}")
    assert ex["n_unexplained"] == 0 and ex["own_masks_err"] <= DX_TOL[dtype], ex
    assert ex["share"] <= DX_ROW_SHARE[dtype], ex
    assert all(f["n_unexplained"] > 0 for f in ex["faults"].values()), ex
    alone = b(wts, x, g, dtype, model, mip=True)
    assert all(torch.equal(a, c) for a, c in zip(got, alone))
    with pytest.raises(ValueError, match="windows"):
        b(wts, x, g, dtype, model, mip=True, want_dx=True, enc_w=mlp.anneal_row_weights(model, 0.3, dev))


@pytest.mark.parametrize("kind", ["mip1", "mip2", "proposal"])
def test_pose_mip_and_proposal_steps_on_the_card(dev, kind):
    """One f32 pose loss from one state with mip (one and two levels) or
    with proposal sampling (the anneal at alpha 0.4) through the kernels
    (the forward and B2 with the input gradient: its mip instantiation
    under mip) against the same loss on the xla backend, at the same edges
    (and fine edges) or probes and samples: the loss to LOSS_TOL, each
    gradient of the field(s) within 1e-3 of the largest gradient entry of
    the field(s), and dr and dt within 1e-3 of the larger of their largest
    entries. (Per tensor the scale can be a sum that cancels: with the
    random fine edges of ``mip2``, an interval of 2e-6, trunk0's gradient
    peaks at 2.6e-6 against 3e-3 elsewhere and dt's at 1.7e-4 against dr's
    6.2e-3, and the xla and pallas paths differ there by 2.2e-3 / 4.5e-3 of
    that peak on the CPU too, where both run plain torch.) The launches
    counted where they launch (no plain fallback); then one pallas pose
    step through ``build_train_step`` moves the deltas."""
    import dataclasses

    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.models.proposal import ProposalField, ProposalMLP, ProposalPair, init_proposal_params
    from nerf_simple_tpu_torch.train.step import (CamDeltas, autograd_loss, build_train_step, make_train_state,
                                                  render_settings)

    model, n_img, hw, B, N = NerfMLP(Lp=6, Ld=3, H=64), 4, 256, 512, 32
    extra = (dict(mip=True, mip_levels=int(kind[-1])) if kind.startswith("mip") else
             dict(proposal=True, Np=16, prop_Lp=4, prop_D=2, prop_H=32, pe_anneal_until=10))
    cfg = TrainConfig(datapath="d", Nf=N, batch_size=B, backend="pallas", compute_dtype="f32", net_H=64, net_Lp=6,
                      net_Ld=3, pose_opt=True, pose_warmup=0, **extra)
    rng = np.random.default_rng(13)
    d = rng.normal(size=(n_img * hw, 3))
    rays = torch.from_numpy(np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True), d], 1)
                            .astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (n_img * hw, 3)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, n_img * hw, B)).to(dev)
    n_ts = N + 1 if cfg.mip else cfg.Np
    ts = torch.from_numpy(np.sort(rng.uniform(2, 6, (B, n_ts)), -1).astype(np.float32)).to(dev)
    fine = torch.from_numpy(np.sort(rng.uniform(2, 6, (B, N + 1)), -1).astype(np.float32)).to(dev)
    tables = {k: rng.normal(0, 0.02, (n_img, 3)).astype(np.float32) for k in ("dr", "dt")}
    radius = 2.0 / 12.0**0.5 / 100.0
    got = {}
    for backend in ("pallas", "xla"):
        if cfg.proposal:
            pm = ProposalMLP(Lp=4, D=2, H=32)
            field = ProposalPair(ProposalField.from_jax_params(init_proposal_params(3, pm), dev, pm),
                                 NerfField.from_jax_params(init_nerf_params(4, model), dev))
        else:
            field = NerfField.from_jax_params(init_nerf_params(4, model), dev)
        cams = CamDeltas(n_img, dev).copy_tables_(tables)
        c = dataclasses.replace(cfg, backend=backend)
        b2 = mlp.fused_mlp_backward
        before = (b2.dx_launches, b2.mip_dx_launches, mlp.input_grad_launches(), mlp.input_grad_mip_launches())
        loss = autograd_loss(c, field, rays[idx], pix[idx], ts, None, render_settings(c, radius), det_fine=True,
                             edges_fine=fine if cfg.mip_levels == 2 else None, cams=cams, im_b=idx // hw,
                             enc_alpha=0.4 if cfg.proposal else None)
        loss.backward()
        torch.cuda.synchronize()
        n = (backend == "pallas") * (cfg.mip_levels if cfg.mip else 1)
        n_mip = n if cfg.mip else 0
        assert (b2.dx_launches, b2.mip_dx_launches, mlp.input_grad_launches(),
                mlp.input_grad_mip_launches()) == (before[0] + n, before[1] + n_mip, before[2] + n, before[3] + n_mip)
        got[backend] = (loss.item(), [p.grad for p in field.parameters()], [cams.dr.grad, cams.dt.grad])
    (lp, fp, cp), (lx, fx, cx) = got["pallas"], got["xla"]
    assert abs(lp / lx - 1) <= LOSS_TOL[torch.float32]
    for ps, xs in ((fp, fx), (cp, cx)):
        scale = max(t.abs().max().item() for t in xs)
        for a, b in zip(ps, xs):
            assert (a - b).abs().max().item() <= 1e-3 * scale
    state = make_train_state(cfg, model, dev, n_images=n_img)
    out = build_train_step(cfg, model, rays_per_image=hw, base_radius=radius)(state, rays, pix)
    assert bool(torch.isfinite(out)) and float(state.cams.dr.detach().abs().max()) > 0


# --- scene contraction: the encoder's contracted instantiations (CONTRACT) ---------------------

CONTRACT_CASES = [(NerfMLP(Lp=4, Ld=2, H=32), 1000), (NerfMLP(Lp=3, Ld=1, H=48), 65), (NerfMLP(), 4096 + 17)]
CONTRACT_IDS = ["small-ragged", "odd-widths-65", "flagship-ragged"]


def _contracted(model):
    import dataclasses

    return dataclasses.replace(model, contract=True)


def _x_contract(rows, dev, seed, mip=False, inside_only=False):
    """Sample rows on both sides of the unit ball: a third at |x| in [0.2,
    0.999], a third in [1.001, 3], the rest at 25..35 (an unbounded
    scene's background); unit dirs; under ``mip`` 16 rows, the variances
    (rows 11..13) log-uniform in [1e-6, 1e-1]. ``inside_only``: every row
    inside the ball."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, rows))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    radius = np.concatenate([rng.uniform(0.2, 0.999, rows - 2 * (rows // 3)), rng.uniform(1.001, 3.0, rows // 3),
                             rng.uniform(25.0, 35.0, rows // 3)])
    radius = rng.uniform(0.0, 0.999, rows) if inside_only else rng.permutation(radius)
    d = rng.normal(size=(3, rows))
    x = np.zeros((16 if mip else 8, rows), np.float32)
    x[:3] = u * radius
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    if mip:
        x[11:14] = 10.0 ** rng.uniform(-6, -1, (3, rows))
    return torch.from_numpy(x).to(dev), torch.from_numpy(radius <= 1.0).to(dev)


def _faulty_plain(monkeypatch, fault):
    """Plant a fault in the plain version: ``raw`` leaves posx's raw rows
    uncontracted, ``var`` drops the variance warp under mip."""
    if fault == "raw":
        encode = mlp._encode

        def raw(xT, model, var=None, enc_w=None):
            posx, posd = encode(xT, model, var, enc_w)
            return torch.cat([xT[0:3], posx[3:]]), posd
        monkeypatch.setattr(mlp, "_encode", raw)
    else:
        contract = mlp._contract
        monkeypatch.setattr(mlp, "_contract", lambda xyz, var: (contract(xyz, var)[0], var))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
@pytest.mark.parametrize("model, rows", CONTRACT_CASES, ids=CONTRACT_IDS)
def test_forward_contract_matches_plain(dev, model, rows, mip, dtype):
    """The forward of a contracted model (the encoder's contraction, and
    under mip its variance warp) against its plain version at ragged rows
    on both sides of the unit ball and far out; counted in Python and in C;
    at the rows inside the ball bit-equal to the launch without contract,
    elsewhere not."""
    cm = _contracted(model)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x, inside = _x_contract(rows, dev, 1, mip)
    before = (mlp.fused_mlp_forward.contract_launches, mlp.contract_launches())
    got = mlp.fused_mlp_forward(wts, x, dtype, cm, mip=mip)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_forward.contract_launches, mlp.contract_launches()) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_mlp_forward_plain(wts, x, dtype, cm, mip=mip)
    assert bool(torch.isfinite(got).all()) and bool((got[4:] == 0).all())
    assert (got[:4] - want[:4]).abs().max().item() <= TOL[dtype]
    plain_launch = mlp.fused_mlp_forward(wts, x, dtype, model, mip=mip)
    assert torch.equal(got[:, inside], plain_launch[:, inside])
    assert (got[:4, ~inside] - plain_launch[:4, ~inside]).abs().max().item() > TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fault", ["raw", "var"])
def test_forward_contract_catches_a_planted_fault(dev, monkeypatch, fault, dtype):
    """A fault planted in the plain version of the flagship's contracted
    forward, the raw rows left uncontracted (point) or the variance warp
    dropped (mip), puts it past the tolerance from the kernel: the check
    above would catch a kernel with that fault."""
    model, mip = NerfMLP(), fault == "var"
    cm = _contracted(model)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x, _ = _x_contract(4096 + 17, dev, 1, mip)
    got = mlp.fused_mlp_forward(wts, x, dtype, cm, mip=mip)
    assert (got[:4] - mlp.fused_mlp_forward_plain(wts, x, dtype, cm, mip=mip)[:4]).abs().max().item() <= TOL[dtype]
    _faulty_plain(monkeypatch, fault)
    faulty = mlp.fused_mlp_forward_plain(wts, x, dtype, cm, mip=mip)
    assert (got[:4] - faulty[:4]).abs().max().item() > 5 * TOL[dtype]


@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48)], ids=["flagship", "odd-widths"])
def test_f32_forward_contract_residual_planes_match_plain(dev, model, mip):
    """The f32 forward of a contracted model keeps the contracted encoding
    in posx's residual plane (its raw rows too), which B1's and B2's weight
    gradients read: every plane against the plain ``_forward``."""
    rows = 132 * FWD_TILE + 17
    cm = _contracted(model)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev))
    x, _ = _x_contract(rows, dev, 2, mip)
    out, res = mlp.forward_residuals(wts, x, torch.float32, cm, mip=mip)
    torch.cuda.synchronize()
    want_out, want = mlp.forward_residuals_plain(wts, x, torch.float32, cm, mip=mip)
    assert (out[:4] - want_out[:4]).abs().max().item() <= TOL[torch.float32]
    assert (res[0:3, :rows] - want[0:3, :rows]).abs().max().item() <= 1e-6  # the contracted raw rows
    err = (res[:, :rows] - want[:, :rows]).abs().max().item()
    assert err <= 2e-4 * max(1.0, want[:, :rows].abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
@pytest.mark.parametrize("model, rows", CONTRACT_CASES, ids=CONTRACT_IDS)
def test_backward_contract_matches_plain(dev, model, rows, mip, dtype):
    """B2 recomputing a contracted model's forward against its plain
    version; counted; with every row inside the ball bit-equal to B2
    without contract; no input gradient (ROADMAP Queue B item 3)."""
    cm = _contracted(model)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x, _ = _x_contract(rows, dev, 3, mip)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(8, rows)).astype(np.float32)).to(dev)
    before = (mlp.fused_mlp_backward.contract_launches, mlp.contract_launches())
    got = mlp.fused_mlp_backward(wts, x, g, dtype, cm, mip=mip)
    torch.cuda.synchronize()
    assert (mlp.fused_mlp_backward.contract_launches, mlp.contract_launches()) == (before[0] + 1, before[1] + 1)
    errs = _grad_errors(got, mlp.fused_mlp_backward_plain(wts, x, g, dtype, cm, mip=mip))
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    xi, _ = _x_contract(rows, dev, 4, mip, inside_only=True)
    assert all(torch.equal(a, b) for a, b in zip(mlp.fused_mlp_backward(wts, xi, g, dtype, cm, mip=mip),
                                                 mlp.fused_mlp_backward(wts, xi, g, dtype, model, mip=mip)))
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        mlp.fused_mlp_backward(wts, x, g, dtype, cm, mip=mip, want_dx=True)


def _x16_contract(B, N, dev, seed, mip=False, inside_only=False):
    """B1's input for a contracted model: rays from r = 3..6 (an unbounded
    scene's cameras) at sorted random ts in [0.5, 30] (or their interval
    edges under mip, cone radius MIP_RADIUS), the gt colour on each
    sample; ``inside_only``: rays from near the origin with ts in [0, 0.5]."""
    from nerf_simple_tpu_torch.train.step import build_x16, build_x16_mip

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.normal(0, 0.05, (B, 3)) if inside_only else -rng.uniform(3, 6, (B, 1)) * d
         + rng.normal(0, 0.3, (B, 3)))
    lo, hi = (0.0, 0.5) if inside_only else (0.5, 30.0)
    rays = torch.from_numpy(np.concatenate([o, d], 1).astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)).to(dev)
    ts = torch.from_numpy(np.sort(rng.uniform(lo, hi, (B, N + mip)), -1).astype(np.float32)).to(dev)
    return build_x16_mip(rays, ts, pix, MIP_RADIUS) if mip else build_x16(rays, ts, pix)


CONTRACT_B1_CASES = {"point": dict(), "point-weights-rail-disparity": dict(out_weights=True,
                                                                          dist=(0.01, 0.5, 30.0, True)),
                     "mip": dict(mip=True), "mip-weights-opaque": dict(mip=True, out_weights=True, opaque_tail=True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CONTRACT_B1_CASES))
@pytest.mark.parametrize("model, B, N", [(NerfMLP(Lp=4, Ld=2, H=32), 37, 64), (NerfMLP(), 41, 128)],
                         ids=["small-N64", "flagship-N128"])
def test_train_step_contract_matches_plain(dev, model, B, N, case, dtype):
    """B1 of a contracted model, point and cone-cast, with the weights
    output and the disparity-space rail of the 360 recipe, against its
    plain version: loss, gradients and weights within B1's bounds;
    counted; deterministic; on rays that stay inside the ball bit-equal
    to B1 without contract."""
    kw = CONTRACT_B1_CASES[case]
    mip = kw.get("mip", False)
    cm = _contracted(model)
    x16 = _x16_contract(B, N, dev, 5, mip)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    before = (mlp.fused_train_step.contract_launches, mlp.contract_launches())
    out = mlp.fused_train_step(wts, x16, N, dtype, cm, **kw)
    torch.cuda.synchronize()
    assert (mlp.fused_train_step.contract_launches, mlp.contract_launches()) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_train_step_plain(wts, x16, N, dtype, cm, **kw)
    assert abs(out[0].item() / want[0].item() - 1) <= LOSS_TOL[dtype]
    errs = _grad_errors(out[1], want[1])
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    if kw.get("out_weights"):
        assert (out[2] - want[2]).abs().max().item() <= TOL[dtype]
    again = mlp.fused_train_step(wts, x16, N, dtype, cm, **kw)
    assert again[0].item() == out[0].item() and all(torch.equal(a, b) for a, b in zip(out[1], again[1]))
    xi = _x16_contract(B, N, dev, 6, mip, inside_only=True)
    a, b = mlp.fused_train_step(wts, xi, N, dtype, cm, **kw), mlp.fused_train_step(wts, xi, N, dtype, model, **kw)
    assert a[0].item() == b[0].item() and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_render_contract_matches_plain(dev, dtype):
    """B3 of a contracted model against its plain version; counted; on
    rays inside the ball bit-equal to B3 without contract."""
    model = NerfMLP()
    cm = _contracted(model)
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), dev)), dtype)
    x16 = _x16_contract(67, 128, dev, 7)
    before = (mlp.fused_render.contract_launches, mlp.contract_launches())
    got = mlp.fused_render(wts, x16, 128, dtype, cm)
    torch.cuda.synchronize()
    assert (mlp.fused_render.contract_launches, mlp.contract_launches()) == (before[0] + 1, before[1] + 1)
    want = mlp.fused_render_plain(wts, x16, 128, dtype, cm)
    assert (got[:3] - want[:3]).abs().max().item() <= TOL[dtype]
    assert ((got[3] - want[3]).abs() / want[3].abs().clamp_min(1.0)).max().item() <= 1e-3
    xi = _x16_contract(67, 128, dev, 8, inside_only=True)
    assert torch.equal(mlp.fused_render(wts, xi, 128, dtype, cm), mlp.fused_render(wts, xi, 128, dtype, model))


def test_contract_refusals_on_the_card(dev):
    """What a contracted model does not run yet raises before any launch
    (ROADMAP Queue B item 3): ``fused_mlp`` on an input that needs a
    gradient, the input-gradient kernel; appearance codes with contract."""
    model = NerfMLP(Lp=4, Ld=2, H=32, contract=True)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, NerfMLP(Lp=4, Ld=2, H=32)), dev))
    x, _ = _x_contract(256, dev, 9)
    before = mlp.contract_launches()
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        mlp.fused_mlp(wts, x.requires_grad_(True), torch.float32, model)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        mlp.input_grad(wts, x.detach(), torch.zeros(1, device=dev), torch.float32, model)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        NerfField(NerfMLP(Lp=4, Ld=2, H=32, contract=True, app_dim=2), dev)
    assert mlp.contract_launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_360_recipe_core_and_step_on_the_card(dev, monkeypatch, dtype):
    """The 360 recipe's fused core (proposal sampling + the disparity-space
    distortion rail, contracted main field and proposal net) with the CUDA
    B1 against the same core with B1's plain version at the same probes
    and samples: the loss and every gradient of both nets within B1's
    bounds; one contracted B1 launch with the weights output and the rail;
    then one step of the recipe through ``build_train_step``."""
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.models.proposal import ProposalField, ProposalMLP, ProposalPair, init_proposal_params
    from nerf_simple_tpu_torch.train import step as step_mod

    model, pm, B, Np, N = NerfMLP(Lp=6, Ld=3, H=64, contract=True), ProposalMLP(Lp=4, D=2, H=32, contract=True), \
        256, 32, 64
    rng = np.random.default_rng(10)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate([-rng.uniform(3, 6, (B, 1)) * d, d], 1).astype(np.float32)).to(dev)
    pix = torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)).to(dev)
    ts_p, ts_f = (torch.from_numpy(1.0 / np.sort(rng.uniform(1 / 30.0, 1 / 0.5, (B, n)), -1)[:, ::-1].copy()
                                   .astype(np.float32)).to(dev) for n in (Np, N))
    dist = (0.01, 0.5, 30.0, True)

    def plain(wts, x16, N, compute_dtype, model, out_weights=False, dist=None, mip=False, opaque_tail=False):
        with torch.no_grad():
            return mlp.fused_train_step_plain(mlp._cast_weights(wts, compute_dtype), x16, N, compute_dtype, model,
                                              out_weights, dist, mip, opaque_tail)

    runs = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(step_mod, "fused_train_step", plain)
        pair = ProposalPair(ProposalField.from_jax_params(init_proposal_params(3, pm), dev, pm),
                            NerfField.from_jax_params(init_nerf_params(4, NerfMLP(Lp=6, Ld=3, H=64)), dev, model))
        before = (mlp.fused_train_step.contract_launches, mlp.fused_train_step.weights_dist_launches)
        loss, _ = step_mod.proposal_fused_loss(pair, rays, pix, ts_p, None, N, dtype, model, dist=dist, ts_f=ts_f)
        torch.cuda.synchronize()
        runs[name] = (loss.item(), {n: p.grad.clone() for n, p in pair.named_parameters()},
                      (mlp.fused_train_step.contract_launches - before[0],
                       mlp.fused_train_step.weights_dist_launches - before[1]))
    monkeypatch.undo()
    (loss, grads, launched), (loss_p, grads_p, launched_p) = runs["kernel"], runs["plain"]
    assert launched == (1, 1) and launched_p == (0, 0)
    assert abs(loss / loss_p - 1) <= LOSS_TOL[dtype]
    for n, gp in grads_p.items():
        err = ((grads[n] - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        assert err <= GRAD_TOL[dtype], (n, err)
    cfg = TrainConfig(datapath="d", Nf=N, batch_size=B, backend="pallas", compute_dtype="bf16", net_H=64, net_Lp=6,
                      net_Ld=3, contract=True, sampling_space="disparity", tn=0.5, tf=30.0, proposal=True, Np=Np,
                      prop_Lp=4, prop_D=2, prop_H=32, distortion_loss_weight=0.01)
    state = step_mod.make_train_state(cfg, model, dev)
    assert state.field.prop.model.contract and state.field.fine.model.contract
    w0 = state.field.fine.trunk1.weight.detach().clone()
    before = mlp.contract_launches()
    out = step_mod.build_train_step(cfg, model)(state, rays, pix)
    assert mlp.contract_launches() == before + 1
    assert bool(torch.isfinite(out)) and not torch.equal(w0, state.field.fine.trunk1.weight)
