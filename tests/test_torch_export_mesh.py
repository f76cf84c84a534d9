"""The port's mesh export (export_mesh.py) on CPU against the JAX package:
the derived marching-tetrahedra case table, marching tetrahedra on
analytic fields, the .obj writer, the density lattice through the density
probe, and the CLI on an .npz export and a training checkpoint.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances:

- the case table, marching tetrahedra and the .obj text: exact (the same
  numpy operations on the same lattice);
- ``density_grid`` (softplus of the density probe): f32 atol 1e-4 (JAX's
  XLA ``nerf_apply`` and the port's MLPs sum in other orders); bf16 atol
  2e-2 (an activation may round to the neighbouring bf16), as
  tests/test_torch_occupancy.py holds ``density_fn``.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.export_mesh as jmesh
import nerf_simple_tpu.models.nerf as jnerf
from nerf_simple_tpu_torch import export_mesh
from nerf_simple_tpu_torch.config import TrainConfig
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train.step import make_train_state

SMALL = NerfMLP(Lp=2, Ld=2, H=32)


def _sphere_grid(R, aabb, radius=1.0):
    xs = np.linspace(-aabb, aabb, R + 1, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return 2.0 - np.sqrt(gx**2 + gy**2 + gz**2)  # the iso 2 - radius surface at |x| = radius


def _jtree(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def test_case_table_is_jax_s():
    assert export_mesh._CASES == jmesh._CASES
    np.testing.assert_array_equal(export_mesh._TETS, jmesh._TETS)
    np.testing.assert_array_equal(export_mesh._CORNERS, jmesh._CORNERS)


def test_marching_tets_recover_the_sphere_as_jax():
    R, aabb, radius = 32, 1.5, 1.0
    grid = _sphere_grid(R, aabb, radius)
    verts, faces = export_mesh.marching_tetrahedra(grid, 2.0 - radius, aabb)
    jv, jf = jmesh.marching_tetrahedra(grid, 2.0 - radius, aabb)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    assert verts.dtype == np.float32 and faces.dtype == np.int32 and len(faces) == len(verts) // 3 > 300
    # JAX's own checks (tests/test_export_mesh.py:23-38): on the sphere to a cell, area within 10%
    assert np.all(np.abs(np.linalg.norm(verts, axis=-1) - radius) < 2 * aabb / R)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1).sum()
    assert abs(area - 4 * np.pi * radius**2) < 0.1 * 4 * np.pi


@pytest.mark.parametrize("fill", [0.0, 5.0], ids=["empty", "full"])
def test_marching_tets_empty_and_full_grids(fill):
    v, f = export_mesh.marching_tetrahedra(np.full((9, 9, 9), fill, np.float32), iso=1.0, aabb=1.0)
    assert v.shape == (0, 3) and f.shape == (0, 3) and v.dtype == np.float32 and f.dtype == np.int32


def test_write_obj_is_jax_s(tmp_path):
    verts, faces = export_mesh.marching_tetrahedra(_sphere_grid(6, 1.5), 1.0, 1.5)
    export_mesh.write_obj(str(tmp_path / "a.obj"), verts, faces)
    jmesh.write_obj(str(tmp_path / "b.obj"), verts, faces)
    text = (tmp_path / "a.obj").read_text()
    assert text == (tmp_path / "b.obj").read_text()
    lines = text.splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(verts) and "f 1 2 3" in lines


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_density_grid_matches_jax(dtype):
    """The (R+1)^3 lattice through the probe, in chunks with a padded last
    one (here 125 rows in chunks of 48), on both backends (the forward
    kernel's plain version under "pallas")."""
    params = init_nerf_params(0, SMALL)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jmesh.density_grid(_jtree(params), jnerf.NerfMLP(2, 2, 32), R=4, aabb=1.0, dtype=jdt, chunk=48)
    field = NerfField.from_jax_params(params, "cpu")
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    for backend in ("xla", "pallas"):
        got = export_mesh.density_grid(field, R=4, aabb=1.0, backend=backend, compute_dtype=dtype, chunk=48)
        assert got.shape == (5, 5, 5) and np.isfinite(got).all() and (got > 0).all()
        np.testing.assert_allclose(got, want, atol=atol)


def test_extract_mesh_and_the_cli(tmp_path, capsys):
    """extract_mesh on a field as JAX's on its params; the CLI on an .npz
    export and on a training checkpoint of a hierarchical run (its fine
    net) writes the same valid .obj."""
    params = init_nerf_params(0, SMALL)
    field = NerfField.from_jax_params(params, "cpu")
    out = str(tmp_path / "m.obj")
    verts, faces = export_mesh.extract_mesh(field, out, R=12, aabb=1.0, iso=0.7)
    jv, jf = jmesh.extract_mesh(_jtree(params), jnerf.NerfMLP(2, 2, 32), str(tmp_path / "j.obj"), R=12, aabb=1.0,
                                iso=0.7)
    assert len(faces) > 0 and len(faces) == len(jf) and os.path.getsize(out) > 0
    np.testing.assert_allclose(verts, jv, atol=1e-4)
    export_mesh.extract_mesh(field, str(tmp_path / "none.obj"), R=4, aabb=1.0, iso=100.0)
    assert "no surface at iso=100.0" in capsys.readouterr().out
    ckpt.export_params_npz(str(tmp_path / "p.npz"), params)
    ckpt.save_model_meta(str(tmp_path), SMALL)
    export_mesh.main(["--loadpath", str(tmp_path / "p.npz"), "--out", str(tmp_path / "cli.obj"), "--resolution",
                      "12", "--aabb", "1.0", "--iso", "0.7", "--device", "cpu", "--backend", "pallas"])
    assert f"{len(faces)} faces" in capsys.readouterr().out
    cfg = TrainConfig(datapath="d", hierarchical=True, Nc=8, net_H=32, net_Lp=2, net_Ld=2)
    state = make_train_state(cfg, SMALL, "cpu")
    exp = tmp_path / "exp"
    ckpt.save_checkpoint(str(exp), state)
    ckpt.save_model_meta(str(exp), SMALL)
    export_mesh.main(["--loadpath", str(exp), "--out", str(tmp_path / "ck.obj"), "--resolution", "8", "--aabb",
                      "1.0", "--iso", "0.7", "--device", "cpu"])
    fine = NerfField.from_jax_params(state.field.fine.to_jax_params(), "cpu")
    _, want = export_mesh.extract_mesh(fine, str(tmp_path / "fine.obj"), R=8, aabb=1.0, iso=0.7)
    assert f"{len(want)} faces" in capsys.readouterr().out
    assert (tmp_path / "ck.obj").read_text() == (tmp_path / "fine.obj").read_text()
    if not torch.cuda.is_available():  # the default device is the card: without one the CLI raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_mesh.main(["--loadpath", str(tmp_path / "p.npz"), "--out", str(tmp_path / "x.obj")])
