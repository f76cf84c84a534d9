"""The backward tile kernel's plain version (kernels/mlp.py::
backward_tile_plain) against the JAX package's ``_backprop_tile``
(nerf_simple_tpu/kernels/mlp.py:757), whose chain of mTg products it
ports, and the wrapper ``backward_tile`` on CPU tensors.

The same weights, inputs and cotangents, made with numpy from a seed, go
to both packages. The residuals are the port's plain forward's; JAX's
posx and posd also carry its constant bias rail (row 3 = 1), which the
port does not have: the port keeps biases apart, so its weight gradients
have a zero rail column where JAX's hold the rail sums, and the port's
bias gradients are those sums (b1, bs, the colour half of bcs) or row
sums of the stored cotangents (the other biases; JAX sums them before
rounding).

Tolerances, per tensor, max abs error over the JAX tensor's largest
entry. f32: the same f32 products summed in another order: 1e-5. bf16:
both sides round the same operands, but a different summation order can
flip the bf16 rounding of an occasional cotangent by one ulp (2^-8) and
the layers below carry it: 1e-3 for weight gradients and input
cotangents (5e-6 measured at these sizes); the non-rail biases also
differ by the rounding of each term they sum (up to 2^-9 of it): 1e-2
(2e-3 measured). The CUDA kernel is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.probes import bwd_tile

MODELS = [NerfMLP(Lp=4, Ld=2, H=32), NerfMLP(Lp=4, Ld=2, H=64)]
MODEL_IDS = ["H32", "H64"]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}  # weight gradients, input cotangents
REL_BIAS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
RAIL = {"W1": "posx", "Wsx": "posx", "Wcd": "posd"}  # gradients with a rail column in JAX
BIAS_OF = dict(Wc1="bc1", Wcs="bcs", Wp1="bp1", Wp0="bp0", Wsh="bs", Wt4="bt4", Wt3="bt3", Wt2="bt2",
               Wt1="bt1", W1="b1")


def _case(model, rows, seed=0):
    """(params, packed f32 weights, residual planes (FA, rows) f32, g (8,
    rows) f32) for one seed; g rows 0..3 normal, 4..7 zero."""
    rng = np.random.default_rng(seed)
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-2, 2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    g = np.zeros((8, rows), np.float32)
    g[:4] = rng.normal(size=(4, rows)) * 0.1
    params = init_nerf_params(seed, model)
    wts = mlp.pack_weights(NerfField.from_jax_params(params, "cpu"))
    _, r = mlp._forward(wts, torch.from_numpy(x), torch.float32, model)
    return params, wts, torch.cat([r.posx, r.posd, *r.h, r.hc]), torch.from_numpy(g)


def _jax_backprop(params, res, g, model, jdt):
    """JAX _backprop_tile on the same residuals (its posx/posd with the
    rail row) and cotangents, with want_pos_grads."""
    jm = jnerf.NerfMLP(model.Lp, model.Ld, model.H)
    jw = jmlp.pack_weights({k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}, model=jm)
    L = mlp.Layout.of(model)
    r = res.numpy().copy()
    r[L.posx + 3] = 1.0
    r[L.posd + 3] = 1.0
    planes = [r[L.posx : L.posd], r[L.posd : L.h(0)]] + [r[L.h(l) : L.h(l) + L.H] for l in range(8)]
    planes.append(r[L.hc : L.FA])
    g8, s8 = np.zeros_like(g.numpy()), np.zeros_like(g.numpy())
    g8[:3], s8[0] = g.numpy()[:3], g.numpy()[3]
    return jmlp._backprop_tile(jw, tuple(jnp.asarray(p) for p in planes), jnp.asarray(g8), jnp.asarray(s8),
                               jdt, jm, want_pos_grads=True)


def _close(got, want, rel, what):
    got = got.double().numpy()
    want = np.asarray(want, np.float64).reshape(got.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_sums_of_the_plain_planes_are_the_jax_backprop_grads(model, dt, jdt):
    """The twelve weight-gradient sums (weight_grad_plain over
    wgrad_tasks' pairs) of backward_tile_plain's planes give JAX's
    _backprop_tile gradients."""
    params, wts, res, g = _case(model, 192, seed=1)
    w = mlp._cast_weights(wts, dt)
    gws = mlp.backward_tile_plain(w, res, g, dt, model)
    assert gws.shape == (mlp.Layout.of(model).FG, 192) and gws.dtype == torch.float32
    want, _ = _jax_backprop(params, res, g, model, jdt)
    for t in mlp.wgrad_tasks(model):
        dW, db = mlp.weight_grad_plain(gws[t.gf : t.gf + t.O], res[t.af : t.af + t.K], dt)
        jW = np.array(getattr(want, t.name))
        if t.name in RAIL:
            jW[:, 3] = 0.0  # the port's residual has no rail row
        _close(dW, jW, REL[dt], t.name)
        if t.bias:
            _close(db, getattr(want, BIAS_OF[t.name]), REL_BIAS[dt], BIAS_OF[t.name])


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_plain_planes_give_the_jax_input_cotangents(model, dt, jdt):
    """JAX's want_pos_grads outputs from the port's planes: g_posx = W1^T
    g_h0 + Wsx^T g_h5 and g_posd = Wcd^T g_hc."""
    params, wts, res, g = _case(model, 128, seed=2)
    w = mlp._cast_weights(wts, dt)
    L, H2 = mlp.Layout.of(model), model.H // 2
    gws = mlp.backward_tile_plain(w, res, g, dt, model)
    g_posx = (mlp._mm(w.W1.T, gws[L.gh(0) : L.gh(0) + L.H], dt)
              + mlp._mm(w.Wsx.T, gws[L.gh(5) : L.gh(5) + L.H], dt))
    g_posd = mlp._mm(w.Wcd.T, gws[L.gcs : L.gcs + H2], dt)
    _, (jx, jd, _) = _jax_backprop(params, res, g, model, jdt)
    _close(g_posx, jx, REL[dt], "g_posx")
    _close(g_posd, jd, REL[dt], "g_posd")


def test_plain_planes_hold_the_rounded_chain():
    """bf16: each plane is rounded to bf16 once (it survives a round trip),
    the sigma rows of g_cs are [g_sigma ; 0 x 7], and g_rgb8 is [d_rgb ;
    0 x 5]; f32 differs from bf16."""
    model = MODELS[0]
    _, wts, res, g = _case(model, 64, seed=3)
    L, H2 = mlp.Layout.of(model), model.H // 2
    got = mlp.backward_tile_plain(mlp._cast_weights(wts, torch.bfloat16), res, g, torch.bfloat16, model)
    assert torch.equal(got, got.bfloat16().float())
    assert torch.equal(got[L.gr8 : L.gr8 + 3], g[:3].bfloat16().float())
    assert not got[3:8].any() and not got[L.gcs + H2 + 1 : L.gcs + H2 + 8].any()
    assert torch.equal(got[L.gcs + H2], g[3].bfloat16().float())
    f32 = mlp.backward_tile_plain(wts, res, g, torch.float32, model)
    assert (f32 - got).abs().max() > 1e-6


@pytest.mark.parametrize("rows", [1, 63, 100], ids=["1", "63", "100"])
def test_pad_rows_get_zero_cotangents(rows):
    """Rows past `rows`, up to the 64-row multiple Rp, hold finite
    residuals and get zero cotangents: the sums rely on it."""
    model = MODELS[1]
    _, wts, res, g = _case(model, 128, seed=4)
    Rp = -(-rows // 64) * 64
    got = mlp.backward_tile_plain(wts, res[:, :Rp], g[:, :rows], torch.float32, model)
    assert got.shape[1] == Rp and not got[:, rows:].any()
    assert got[:, :rows].abs().max() > 0
    full = mlp.backward_tile_plain(wts, res[:, :Rp], g[:, :Rp], torch.float32, model)
    assert torch.equal(got[:, :rows], full[:, :rows])  # each row's chain is its own


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_tile_on_cpu_is_the_plain_version(dt):
    model = MODELS[0]
    _, wts, res, g = _case(model, 100, seed=5)
    w = mlp._cast_weights(wts, dt)
    resp = torch.cat([res, torch.ones((res.shape[0], 28))], 1).to(dt)  # Rp = 128
    before = mlp.backward_tile.launches
    got = mlp.backward_tile(w, resp, g, dt, model)
    assert mlp.backward_tile.launches == before  # CPU tensor: no launch
    assert got.dtype == dt and got.shape == (mlp.Layout.of(model).FG, 128)
    assert torch.equal(got.float(), mlp.backward_tile_plain(w, resp, g, dt, model))


def _bad(case):
    model = MODELS[0]
    _, wts, res, g = _case(model, 128, seed=6)
    return wts, {
        "res-rows": (res[:, :64].contiguous(), g),
        "res-features": (res[1:].contiguous(), g),
        "res-type": (res.bfloat16(), g),
        "not-contiguous": (res.T.contiguous().T, g),
        "g-rows": (res, g[:4].contiguous()),
        "g-f64": (res, g.double()),
        "no-rows": (res[:, :0], g[:, :0]),
    }[case], model


@pytest.mark.parametrize("case", ["res-rows", "res-features", "res-type", "not-contiguous", "g-rows", "g-f64",
                                  "no-rows"])
def test_backward_tile_rejects_what_the_kernel_does_not_take(case):
    wts, (res, g), model = _bad(case)
    with pytest.raises(ValueError):
        mlp.backward_tile(wts, res, g, torch.float32, model)


def test_backward_tile_raises_on_other_devices():
    model = MODELS[0]
    L = mlp.Layout.of(model)
    wts = mlp.pack_weights(NerfField(model))
    with pytest.raises(ValueError, match="device"):
        mlp.backward_tile(wts, torch.zeros((L.FA, 64), device="meta"), torch.zeros((8, 64), device="meta"),
                          torch.float32, model)


@pytest.mark.parametrize("model", [NerfMLP(), NerfMLP(Lp=3, Ld=1, H=48), NerfMLP(Lp=1, Ld=1, H=16)],
                         ids=["flagship", "odd-widths", "H16"])
def test_bwd_weight_image_unswizzles_to_the_transposed_weights(model):
    """The bf16 backward's weight image (csrc/bwd_bf16.cuh streams it into
    shared memory slice by slice): undoing the 128-byte swizzle of every
    slice gives back each matrix's transpose in bf16, zeros past its rows
    and columns, in the order the kernel multiplies by them."""
    wts = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), "cpu")),
                            torch.bfloat16)
    image = mlp.bwd_weight_image_plain(wts, model)
    slices = mlp.bwd_image_slices(model)
    assert [n for n, c, _ in slices if c == 0] == list(mlp.BWD_IMAGE_ORDER)
    assert image.numel() * 2 == sum(128 * rows for _, _, rows in slices)
    got = {n: [] for n in mlp.BWD_IMAGE_ORDER}
    pos = 0
    for name, c, rows in slices:
        sl = image[pos : pos + 64 * rows].reshape(rows, 8, 8)
        pos += 64 * rows
        n = torch.arange(rows)[:, None]
        got[name].append(sl[n, torch.arange(8)[None, :] ^ (n % 8)].reshape(rows, 64))  # chunk c at c ^ n % 8
    for name in mlp.BWD_IMAGE_ORDER:
        WT = getattr(wts, name).T.contiguous().view(torch.int16)
        full = torch.cat(got[name], dim=1)
        N, K = WT.shape
        assert torch.equal(full[:N, :K], WT), name
        assert not full[N:].any() and not full[:, K:].any()


def test_probe_smoke_test_on_cpu(capsys):
    """``python -m nerf_simple_tpu_torch.probes.bwd_tile --device cpu`` runs
    the wrapper's plain version and times nothing; the probe's work at
    the flagship: 0.519 TFLOP and 4.59 GB to move (bf16)."""
    bwd_tile.main(["--device", "cpu"])
    assert "times nothing" in capsys.readouterr().out
    flops, nbytes = bwd_tile.work(mlp.FLAGSHIP, bwd_tile.ROWS, torch.bfloat16)
    assert round(flops / 1e12, 3) == 0.519 and round(nbytes / 1e9, 2) == 4.59


BWD_WIDTHS = [NerfMLP(), NerfMLP(Lp=1, Ld=1, H=16), NerfMLP(Lp=3, Ld=1, H=48), NerfMLP(Lp=2, Ld=1, H=128),
              NerfMLP(Lp=2, Ld=1, H=144)]
BWD_WIDTH_IDS = ["flagship", "H16", "H48", "H128", "H144"]


@pytest.mark.parametrize("model", BWD_WIDTHS, ids=BWD_WIDTH_IDS)
def test_f32_bwd_weight_image_gives_the_transposed_weights(model):
    """The f32 backward's weight image (csrc/bwd_f32.cuh streams it into
    shared memory slice by slice): joining each matrix's (16, OP) slices
    [k][o] along k gives its transpose W^T, zeros past its rows and
    columns, in the order the kernel multiplies by them; OP is 128 for
    Wc1^T and 128 per feature group of a thread for the others (256 for
    H > 128): the widths where the kernel's groups switch, H = 128 / 144,
    and the narrow ones, where the padding must be zero."""
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, model), "cpu"))
    image = mlp.f32_bwd_weight_image_plain(wts, model)
    slices = mlp.f32_bwd_image_slices(model)
    ni = 2 if model.H > 128 else 1
    assert [n for n, c, _ in slices if c == 0] == list(mlp.BWD_IMAGE_ORDER)
    assert all(op == (128 if n == "Wc1" else 128 * ni) for n, _, op in slices)
    assert image.dtype == torch.float32 and image.numel() == sum(mlp.F32_KS * op for _, _, op in slices)
    got = {n: [] for n in mlp.BWD_IMAGE_ORDER}
    pos = 0
    for name, c, op in slices:
        got[name].append(image[pos : pos + mlp.F32_KS * op].reshape(mlp.F32_KS, op))
        pos += mlp.F32_KS * op
    for name in mlp.BWD_IMAGE_ORDER:
        WT = getattr(wts, name).T
        full = torch.cat(got[name], dim=0).T  # (OP, 16 x slices): W^T, padded
        O, K = WT.shape
        assert full.shape[1] == -(-K // mlp.F32_KS) * mlp.F32_KS, name
        assert torch.equal(full[:O, :K], WT), name
        assert not full[O:].any() and not full[:, K:].any(), name


def test_f32_backward_plan_fits_the_card():
    """The Python mirror of the f32 backward's shared-memory plan: within
    the H100's 232,448 bytes a block for every H the kernels take, with two
    ring stages at least; at the flagship the 128 KB cotangent tile and six
    16 KB stages."""
    for H in range(16, 257, 16):
        smem = mlp.f32_backward_smem_bytes(NerfMLP(H=H))
        stage = 4 * mlp.F32_KS * (256 if H > 128 else 128)
        assert smem <= mlp.SMEM_LIMIT and smem - 4 * mlp.F32_ROWS * H >= 2 * stage, H
    assert mlp.f32_backward_smem_bytes(NerfMLP()) == 4 * 128 * 256 + 2 * 6 * 8 + 6 * 16384


class _FakeLib:
    """Stands in for a kernel library: records the transposes (C
    ``WeightsT``) an entry is given, answers sizes, launches nothing."""

    def __init__(self):
        self.weights_t = []

    def __getattr__(self, entry):
        def call(*args):
            self.weights_t += [a for a in args if isinstance(a, mlp._CWeightsT)]
            return 64 if entry.endswith("_bytes") else 0
        return call


@pytest.mark.parametrize("entry", ["fused_mlp_backward", "fused_train_step", "backward_tile"])
def test_f32_wrappers_pass_no_transposes(entry, monkeypatch):
    """The f32 wrappers hand their entries null transposes and make no
    transposed copies (``_transposed`` is for earlier libraries): run on a
    stand-in library with the dispatch forced to the kernel path."""
    model = MODELS[0]
    _, wts, res, g = _case(model, 64, seed=7)
    x16 = torch.zeros((16, 64))
    fake = _FakeLib()
    monkeypatch.setattr(mlp, "_dispatch", lambda x: False)
    monkeypatch.setattr(mlp, "_check_launch", lambda *a, **k: (fake, 0))
    monkeypatch.setattr(mlp, "_stream", lambda x: 0)
    monkeypatch.setattr(mlp, "_transposed", lambda w: pytest.fail("a transposed copy was made"))
    wrapper = getattr(mlp, entry)
    before = wrapper.launches
    monkeypatch.setattr(wrapper, "launches", before)  # the stand-in's launch is not counted past the test
    if entry == "fused_mlp_backward":
        mlp.fused_mlp_backward(wts, x16[:8].contiguous(), g, torch.float32, model)
    elif entry == "fused_train_step":
        mlp.fused_train_step(wts, x16, 16, torch.float32, model)
    else:
        mlp.backward_tile(wts, res, g, torch.float32, model)
    assert wrapper.launches == before + 1
    assert len(fake.weights_t) == 1
    assert all(getattr(fake.weights_t[0], f) is None for f, _ in mlp._CWeightsT._fields_)
