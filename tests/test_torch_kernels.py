"""The port's fused MLP forward (kernels/mlp.py) against the JAX package's
Pallas kernel, run in interpret mode as tests/test_kernels.py runs it.

On CPU tensors the port's wrapper takes its plain PyTorch version; the
CUDA kernel itself is compared with that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params, nerf_apply

SMALL = NerfMLP(Lp=4, Ld=2, H=32)


def _jax_model(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _jax_params(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _xT(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-2, 2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    return x


@pytest.mark.parametrize("model", [SMALL, NerfMLP()], ids=["small", "flagship"])
def test_pack_weights_matches_jax(model):
    params = init_nerf_params(0, model)
    got = mlp.pack_weights(NerfField.from_jax_params(params, "cpu"))
    want = jmlp.pack_weights(_jax_params(params), model=_jax_model(model))
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, err_msg=name)


@pytest.mark.parametrize(
    "model, rows, tile", [(SMALL, 512, 128), (NerfMLP(), 256, 128)], ids=["small", "flagship"]
)
def test_fused_forward_f32_matches_jax_kernel_and_reference(model, rows, tile):
    params = init_nerf_params(1, model)
    field = NerfField.from_jax_params(params, "cpu")
    x = _xT(rows, seed=1)
    mlp.fused_mlp_forward.launches = 0
    got = mlp.fused_mlp_forward(mlp.pack_weights(field), torch.from_numpy(x), torch.float32, model).numpy()
    assert got.shape == (8, rows)
    assert mlp.fused_mlp_forward.launches == 0  # CPU tensor: plain version, no launch
    np.testing.assert_array_equal(got[4:], 0.0)
    jp = _jax_params(params)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(
            jmlp.pack_weights(jp, model=_jax_model(model)), jnp.asarray(x),
            tile_rows=tile, compute_dtype=jnp.float32, model=_jax_model(model),
        ))
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-4)
    ref = nerf_apply(field, torch.from_numpy(x[:6].T.copy())).detach().numpy()
    np.testing.assert_allclose(got[:4].T, ref, atol=2e-4)


def test_fused_forward_bf16_matches_jax_kernel():
    """bf16: the same operands are rounded on both sides and summed in
    f32, but in another order; where an activation lands near a rounding
    boundary the two round it to neighbouring bf16 values (2^-8 relative)
    and the later layers carry that: 2e-3 at outputs of order 1."""
    params = init_nerf_params(2, SMALL)
    field = NerfField.from_jax_params(params, "cpu")
    x = _xT(512, seed=2)
    got = mlp.fused_mlp_forward(mlp.pack_weights(field), torch.from_numpy(x), torch.bfloat16, SMALL).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(
            jmlp.pack_weights(_jax_params(params), model=_jax_model(SMALL)), jnp.asarray(x),
            tile_rows=128, compute_dtype=jnp.bfloat16, model=_jax_model(SMALL),
        ))
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-3)
    # and the bf16 rounding is really applied: f32 differs from bf16
    f32 = mlp.fused_mlp_forward(mlp.pack_weights(field), torch.from_numpy(x), torch.float32, SMALL)
    assert np.abs(f32.numpy()[:4] - got[:4]).max() > 1e-5


def test_cast_weights_keeps_biases_f32():
    wts = mlp._cast_weights(mlp.pack_weights(NerfField(SMALL)), torch.bfloat16)
    for name, t in zip(wts._fields, wts):
        assert t.dtype == (torch.float32 if t.shape[-1] == 1 else torch.bfloat16), name
    assert mlp._cast_weights(wts, torch.bfloat16).W1 is wts.W1  # already cast: no copy


def test_unsupported_arch_and_device_raise():
    with pytest.raises(ValueError, match="H % 16"):
        mlp.pack_weights(NerfField(NerfMLP(Lp=2, Ld=2, H=24)))
    wts = mlp.pack_weights(NerfField(SMALL))
    with pytest.raises(ValueError, match="H % 16"):
        mlp.fused_mlp_forward(wts, torch.zeros(8, 128), torch.float32, NerfMLP(Lp=4, Ld=2, H=24))
    with pytest.raises(ValueError, match="device"):
        mlp.fused_mlp_forward(wts, torch.zeros(8, 128, device="meta"), torch.float32, SMALL)
    contracted = NerfMLP(Lp=4, Ld=2, H=32, contract=True)  # the forward runs; an input gradient is not ported
    assert mlp.fused_mlp_forward(wts, torch.zeros(8, 128), torch.float32, contracted).shape == (8, 128)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):  # never silently dropped
        mlp.fused_mlp(wts, torch.zeros(8, 128, requires_grad=True), torch.float32, contracted)


def test_encode_rows_match_jax_layout():
    """The plain encoder's kernel-row order equals the JAX spread-matrix
    encoder's on every row the weights read (raw, sin and cos blocks)."""
    model = NerfMLP(Lp=3, Ld=2, H=16)
    x = _xT(128, seed=3)
    px, pd = mlp._encode(torch.from_numpy(x), model)
    jm = _jax_model(model)
    jx, jd = jmlp._encode(
        jnp.asarray(x), jnp.asarray(jmlp._spread_x(jm)), jnp.asarray(jmlp._spread_d(jm)), jnp.float32, jm
    )
    for got, want, valid in ((px, jx, mlp._valid(3)), (pd, jd, mlp._valid(2))):
        rows = valid > 0
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=1e-6)
        np.testing.assert_array_equal(got.numpy()[~rows], 0.0)


def test_init_params_from_numpy_seed():
    a, b = init_nerf_params(7, SMALL), init_nerf_params(7, SMALL)
    assert all(np.array_equal(a[k]["w"], b[k]["w"]) for k in a)
    assert not isinstance(a["trunk0"]["w"], jax.Array)


@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48), NerfMLP(Lp=1, Ld=1, H=16)],
                         ids=["flagship", "odd-widths", "H16"])
def test_weight_image_unswizzles_to_the_packed_weights(model):
    """The bf16 forward's weight image (csrc/fwd_bf16.cuh streams it into
    shared memory slice by slice): undoing the 128-byte swizzle of every
    slice gives back each packed matrix in bf16, zeros past its rows and
    columns."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), "cpu")),
                            torch.bfloat16)
    image = mlp.weight_image_plain(wts, model)
    slices = mlp.image_slices(model)
    assert image.numel() * 2 == sum(128 * rows for _, _, rows in slices)
    got = {n: [] for n in mlp.IMAGE_ORDER}
    pos = 0
    for name, c, rows in slices:
        sl = image[pos : pos + 64 * rows].reshape(rows, 8, 8)
        pos += 64 * rows
        n = torch.arange(rows)[:, None]
        got[name].append(sl[n, torch.arange(8)[None, :] ^ (n % 8)].reshape(rows, 64))  # chunk c at c ^ n % 8
    for name in mlp.IMAGE_ORDER:
        W = getattr(wts, name).view(torch.int16)
        full = torch.cat(got[name], dim=1)
        O, K = W.shape
        assert torch.equal(full[:O, :K], W)
        assert not full[O:].any() and not full[:, K:].any()


@pytest.mark.parametrize("model", [NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=2, Ld=1, H=32), NerfMLP()],
                         ids=["H16", "H32", "flagship"])
def test_f32_weight_image_unpermutes_to_the_packed_weights(model):
    """The f32 forward's weight image (csrc/fwd_f32.cuh streams it into
    shared memory slice by slice): transposing every (16, OP) slice back
    and joining the slices gives each packed matrix (Wcs: its H/2 colour
    rows), zeros past its rows and columns."""
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), "cpu"))
    image = mlp.f32_weight_image_plain(wts, model)
    slices = mlp.f32_image_slices(model)
    assert image.dtype == torch.float32 and image.numel() == sum(mlp.F32_KS * op for _, _, op in slices)
    assert {op for _, _, op in slices} <= {128, 256} and [n for n, c, _ in slices if c == 0] == list(mlp.F32_IMAGE_ORDER)
    got = {n: [] for n in mlp.F32_IMAGE_ORDER}
    pos = 0
    for name, c, op in slices:
        got[name].append(image[pos : pos + mlp.F32_KS * op].reshape(mlp.F32_KS, op).T)
        pos += mlp.F32_KS * op
    for name in mlp.F32_IMAGE_ORDER:
        W = getattr(wts, name)[: model.H // 2] if name == "Wcs" else getattr(wts, name)
        full = torch.cat(got[name], dim=1)
        O, K = W.shape
        assert torch.equal(full[:O, :K], W), name
        assert not full[O:].any() and not full[:, K:].any(), name


@pytest.mark.parametrize("L", [(10, 4), (1, 1), (1, 4)], ids=["flagship-L", "L1", "posd-apart"])
def test_f32_forward_plan_fits_the_card(L):
    """The Python mirror of the f32 forward's shared-memory plan: within
    the H100's 232,448 bytes a block for every H the kernels take, with two
    ring stages at least, posd inside the posx tile where it fits."""
    FX, FD = mlp._enc_rows(L[0]), mlp._enc_rows(L[1])
    for H in range(16, 257, 16):
        smem = mlp.f32_forward_smem_bytes(NerfMLP(Lp=L[0], Ld=L[1], H=H))
        stage = 4 * mlp.F32_KS * (256 if H > 128 else 128)
        tiles = 4 * mlp.F32_ROWS * (H + FX + (0 if FX >= FD + 8 else FD))
        assert smem <= mlp.SMEM_LIMIT and smem - tiles >= 2 * stage, H
    # the flagship: posd in posx, three 16 KB stages
    assert mlp.f32_forward_smem_bytes(NerfMLP()) == 4 * 128 * (256 + 72) + 64 + 3 * 16384


@pytest.mark.parametrize("rows", [1, 100, 128], ids=["1", "ragged", "two-halves"])
def test_forward_residuals_plain_lays_out_the_forward(rows):
    """On a CPU tensor ``forward_residuals`` is its plain version: the
    forward's output, and ``_forward``'s residuals in the workspace's
    plane layout (Layout), pad rows zero."""
    model = SMALL
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(4, model), "cpu"))
    x = torch.from_numpy(_xT(rows, seed=4))
    mlp.forward_residuals.launches = 0
    out, res = mlp.forward_residuals(wts, x, torch.float32, model)
    assert mlp.forward_residuals.launches == 0
    torch.testing.assert_close(out, mlp.fused_mlp_forward_plain(wts, x, torch.float32, model), rtol=0, atol=0)
    _, r = mlp._forward(wts, x, torch.float32, model)
    L = mlp.Layout.of(model)
    assert res.shape == (L.FA, -(-rows // 64) * 64) and not res[:, rows:].any()
    assert torch.equal(res[L.posx : L.posd, :rows], r.posx) and torch.equal(res[L.hc :, :rows], r.hc)
    for l in range(8):
        assert torch.equal(res[L.h(l) : L.h(l) + L.H, :rows], r.h[l])
