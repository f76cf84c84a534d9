"""The PyTorch port's model, ops and IO against the JAX package on CPU.

Inputs come from a numpy seed and go through both packages; the JAX side
runs on its CPU backend (tests/conftest.py).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.encoding as jenc
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.ops.sampling as jsamp
import nerf_simple_tpu.ops.volume as jvol
import nerf_simple_tpu.train.checkpoint as jckpt
from nerf_simple_tpu_torch.evaluate import load_params
from nerf_simple_tpu_torch.models import infer_model, model_from_meta
from nerf_simple_tpu_torch.models.nerf import (
    NerfField,
    NerfMLP,
    init_nerf_params,
    nerf_apply,
)
from nerf_simple_tpu_torch.ops import encoding, rays, sampling, volume
from nerf_simple_tpu_torch.train import checkpoint

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(rows, seed=0):
    rng = np.random.default_rng(seed)
    v = np.zeros((rows, 6), np.float32)
    v[:, :3] = rng.uniform(-4, 4, (rows, 3))
    d = rng.normal(size=(rows, 3))
    v[:, 3:] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return v


@pytest.mark.parametrize("L", [1, 4, 10])
def test_gamma_matches_jax(L):
    x = _samples(64)[:, :3]
    got = encoding.gamma(torch.from_numpy(x), L).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.gamma(jnp.asarray(x), L)), atol=1e-5)


def test_positional_encoder_matches_jax():
    v = _samples(64, seed=1)
    px, pd = encoding.positional_encoder(torch.from_numpy(v), Lp=10, Ld=4)
    jx, jd = jenc.positional_encoder(jnp.asarray(v), Lp=10, Ld=4)
    assert px.shape == (64, 63) and pd.shape == (64, 27)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-5)


def test_flagship_parameter_count():
    assert sum(p.numel() for p in NerfField(NerfMLP()).parameters()) == 595_844


@pytest.mark.parametrize(
    "model, dtype, atol",
    [
        (SMALL, torch.float32, 1e-5),
        (NerfMLP(), torch.float32, 1e-5),
        # bf16: both round the same operands, but XLA and torch sum in
        # other orders, so an activation can round to a neighbouring bf16
        # value (2^-8 relative) that later layers carry
        (SMALL, torch.bfloat16, 2e-3),
    ],
)
def test_nerf_apply_matches_jax(model, dtype, atol):
    params = init_nerf_params(3, model)
    field = NerfField.from_jax_params(params, "cpu")
    v = _samples(128, seed=2)
    got = nerf_apply(field, torch.from_numpy(v), dtype).detach().numpy()
    jparams = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jnerf.nerf_apply(jparams, jnp.asarray(v), jnerf.NerfMLP(model.Lp, model.Ld, model.H), jdt))
    assert got.shape == (128, 4)
    np.testing.assert_allclose(got, want, atol=atol)


def test_jax_params_round_trip_and_infer():
    params = init_nerf_params(4, SMALL)
    field = NerfField.from_jax_params(params, "cpu")
    assert field.model == SMALL == infer_model(params)
    assert tuple(field.trunk0.weight.shape) == (32, SMALL.in_Cx)
    back = field.to_jax_params()
    for name, layer in params.items():
        np.testing.assert_array_equal(back[name]["w"], layer["w"])
        np.testing.assert_array_equal(back[name]["b"], layer["b"])


def test_unported_families_and_variants_raise():
    with pytest.raises(NotImplementedError, match="hashgrid"):
        model_from_meta({"family": "hashgrid"})
    with pytest.raises(NotImplementedError, match="cpgrid"):
        model_from_meta({"family": "cpgrid"})
    assert model_from_meta({"family": "nerf", "contract": True}).contract  # ported
    assert NerfField(NerfMLP(Lp=2, Ld=2, H=16, contract=True)).model.contract
    assert model_from_meta({"family": "nerf", "contract": True, "app_dim": 2}).app_dim == 2  # ported
    assert NerfField(NerfMLP(Lp=2, Ld=2, H=16, contract=True, app_dim=2)).color0.in_features == 16 + 15 + 2
    assert NerfField(NerfMLP(Lp=2, Ld=2, H=16, app_dim=2)).color0.in_features == 16 + 15 + 2  # ported
    assert model_from_meta({"family": "nerf", "Lp": 4, "Ld": 2, "H": 32}) == SMALL


def test_rays_for_spherical_pose_match_jax():
    pose = rays.spherical_to_pose(4.0, -30.0, 45.0)
    np.testing.assert_allclose(pose, jrays.spherical_to_pose(4.0, -30.0, 45.0), atol=0)
    got = rays.rays_for_poses(torch.as_tensor(pose[None], dtype=torch.float32), 16, 24, 20.0)
    want = jrays.rays_for_poses(jnp.asarray(pose[None], jnp.float32), 16, 24, 20.0)
    assert got.shape == (16 * 24, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("space", ["linear", "disparity"])
def test_stratified_ts_det_matches_jax(space):
    got = sampling.stratified_ts_spaced(None, 5, 16, 2.0, 6.0, "cpu", space=space, det=True)
    want = jsamp.stratified_ts_spaced(None, 5, 16, 2.0, 6.0, space=space, det=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_stratified_ts_random_stays_in_bins():
    g = torch.Generator().manual_seed(0)
    ts = sampling.stratified_ts(g, 64, 8, 2.0, 6.0, "cpu")
    edges = torch.linspace(2.0, 6.0, 9)
    assert bool(((ts >= edges[:-1]) & (ts <= edges[1:])).all())
    again = sampling.stratified_ts(torch.Generator().manual_seed(0), 64, 8, 2.0, 6.0, "cpu")
    assert torch.equal(ts, again)


def _composite_inputs(seed=5, B=12, N=16):
    rng = np.random.default_rng(seed)
    rgb_sigma = rng.normal(size=(B, N, 4)).astype(np.float32)
    rgb_sigma[..., 3] *= 5.0  # opaque and empty samples both
    ts = np.sort(rng.uniform(2, 6, (B, N)), axis=-1).astype(np.float32)
    rays6 = np.concatenate([rng.normal(size=(B, 3)), rng.normal(size=(B, 3))], -1).astype(np.float32)
    return rgb_sigma, ts, rays6


def test_composite_and_sample_points_match_jax():
    rgb_sigma, ts, rays6 = _composite_inputs()
    locs, unit = sampling.sample_points(torch.from_numpy(rays6), torch.from_numpy(ts))
    jlocs, junit = jsamp.sample_points(jnp.asarray(rays6), jnp.asarray(ts))
    np.testing.assert_allclose(locs.numpy(), np.asarray(jlocs), atol=1e-6)
    np.testing.assert_allclose(unit.numpy(), np.asarray(junit), atol=1e-6)
    got = volume.composite(torch.from_numpy(rgb_sigma), torch.from_numpy(ts), unit)
    got_T = volume.composite_T(torch.from_numpy(np.moveaxis(rgb_sigma, -1, 0).copy()), torch.from_numpy(ts), unit)
    want = jvol.composite(jnp.asarray(rgb_sigma), jnp.asarray(ts), junit)
    for out in (got, got_T):
        for name in volume.CompositeOut._fields:
            np.testing.assert_allclose(
                getattr(out, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-5,
                err_msg=name,
            )


def test_params_npz_and_pth_round_trip(tmp_path):
    params = init_nerf_params(6, SMALL)
    npz = str(tmp_path / "params.npz")
    checkpoint.export_params_npz(npz, {"field": {"fine": params, "coarse": params}})
    pth = str(tmp_path / "params.pth")
    checkpoint.export_params_pth(pth, params)
    jp = jckpt.import_params_pth(pth)  # the JAX package reads the port's .pth
    for loaded in (load_params(npz), load_params(pth), jp):
        for name, layer in params.items():
            np.testing.assert_array_equal(np.asarray(loaded[name]["w"]), layer["w"])
            np.testing.assert_array_equal(np.asarray(loaded[name]["b"]), layer["b"])
    with open(tmp_path / "model.json", "w") as fh:
        json.dump({"family": "nerf", "Lp": 4, "Ld": 2, "H": 32, "contract": False, "app_dim": 0}, fh)
    assert checkpoint.load_model_meta(npz) == SMALL
    with pytest.raises(FileNotFoundError, match="ckpt_"):  # no checkpoint in the directory
        load_params(str(tmp_path))
    (tmp_path / "ckpt_5").mkdir()  # a JAX run's Orbax checkpoint directory
    for path in (tmp_path, tmp_path / "ckpt_5"):
        with pytest.raises(NotImplementedError, match="Orbax"):
            load_params(str(path))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_simple_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'nerf_simple_tpu', 'cv2', 'yaml', 'orbax', 'imageio')]\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
