"""Geometry export: a trained density field -> triangle mesh (.obj) (port of
nerf_simple_tpu/export_mesh.py).

The density lattice comes from the occupancy grid's density probe
(``ops/occupancy.py::density_fn``: the forward kernel under ``--backend
pallas``) in chunks of rows on the device; the surface from numpy marching
tetrahedra on the host: each lattice cube splits into six tetrahedra
around its main diagonal, and each sign case emits 0-2 triangles from edge
interpolations (the case table is derived below, not transcribed).

    python -m nerf_simple_tpu_torch.export_mesh --loadpath models/exp \\
        --out mesh.obj --resolution 128 --aabb 2.0 --iso 1.0 [--backend pallas --dtype bf16] [--device cuda]

``iso`` thresholds the softplus density (sigma in 1/world-units); 1.0
means "opaque within ~1 world unit": raise it for tighter surfaces.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# cube corner offsets, ordered so corners 0 and 6 span the main diagonal
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)
# the cube's 6 tetrahedra around the 0-6 diagonal
_TETS = np.array([(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)], np.int64)


def _tet_case_table():
    """case (4-bit inside mask) -> its triangles, each a triple of crossing
    edges, each edge an (inside vertex, outside vertex) pair of tet-local
    ids: 1 or 3 vertices inside emit one triangle, 2 inside a quad split in
    two."""
    table = []
    for case in range(16):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not case >> v & 1]
        tris = []
        if len(inside) == 1:
            tris = [tuple((inside[0], b) for b in outside)]
        elif len(inside) == 3:
            tris = [tuple((a, outside[0]) for a in inside)]
        elif len(inside) == 2:
            (a1, a2), (b1, b2) = inside, outside
            e = [(a1, b1), (a1, b2), (a2, b2), (a2, b1)]  # the quad's cycle
            tris = [(e[0], e[1], e[2]), (e[0], e[2], e[3])]
        table.append(tris)
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(grid: np.ndarray, iso: float, aabb: float) -> tuple[np.ndarray, np.ndarray]:
    """The ``iso`` surface of an (R+1, R+1, R+1) scalar lattice over
    [-aabb, aabb]^3 -> (verts (V, 3) float32 world coordinates, faces
    (F, 3) int32). Vertices are emitted per triangle (not welded)."""
    grid = np.asarray(grid)
    R = grid.shape[0] - 1
    step = 2.0 * aabb / R
    ii = np.arange(R)
    base = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 1, 3)
    corner_idx = base + _CORNERS[None]  # (C, 8, 3)
    vals8 = grid[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # (C, 8)
    pos8 = -aabb + corner_idx.astype(np.float32) * step  # (C, 8, 3)
    # only cubes the surface crosses
    active = (vals8 > iso).any(-1) & (vals8 <= iso).any(-1)
    vals8, pos8 = vals8[active], pos8[active]
    if vals8.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tvals = vals8[:, _TETS].reshape(-1, 4)
    tpos = pos8[:, _TETS].reshape(-1, 4, 3)
    case = ((tvals > iso) << np.arange(4)).sum(-1)
    chunks = []
    for c in range(1, 15):
        sel = np.nonzero(case == c)[0]
        if sel.size == 0:
            continue
        v, p = tvals[sel], tpos[sel]
        for tri in _CASES[c]:
            pts = []
            for a, b in tri:
                va, vb = v[:, a], v[:, b]
                t = np.clip((iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va), 0.0, 1.0)[:, None]
                pts.append(p[:, a] + t * (p[:, b] - p[:, a]))
            chunks.append(np.stack(pts, axis=1))  # (n, 3, 3)
    verts = np.concatenate(chunks).astype(np.float32).reshape(-1, 3)
    return verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3)


def density_grid(field, R: int = 128, aabb: float = 2.0, backend: str = "xla", compute_dtype=torch.float32,
                 chunk: int = 262144) -> np.ndarray:
    """Softplus density at the (R+1)^3 lattice points over [-aabb, aabb]^3
    (host numpy), through ``density_fn`` in chunks of ``chunk`` rows on the
    field's device (the last chunk padded with zeros, as in JAX)."""
    from nerf_simple_tpu_torch.ops.occupancy import density_fn

    fn = density_fn(getattr(field, "fine", field), backend, compute_dtype)
    device = next(field.parameters()).device
    xs = np.linspace(-aabb, aabb, R + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pts)
    pts = torch.as_tensor(np.concatenate([pts, np.zeros(((-n) % chunk, 3), np.float32)]), device=device)
    out = [torch.nn.functional.softplus(fn(pts[i : i + chunk])).cpu() for i in range(0, len(pts), chunk)]
    return torch.cat(out)[:n].numpy().reshape(R + 1, R + 1, R + 1)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write(f"# nerf_simple_tpu mesh: {len(verts)} verts, {len(faces)} faces\n")
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts)
        fh.writelines(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n" for f in faces)


def extract_mesh(field, out_path: str, R: int = 128, aabb: float = 2.0, iso: float = 1.0, backend: str = "xla",
                 compute_dtype=torch.float32) -> tuple[np.ndarray, np.ndarray]:
    """Density field -> .obj file. Returns (verts, faces)."""
    grid = density_grid(field, R=R, aabb=aabb, backend=backend, compute_dtype=compute_dtype)
    verts, faces = marching_tetrahedra(grid, iso, aabb)
    if len(faces) == 0:
        print(f"no surface at iso={iso}: softplus density spans [{grid.min():.3f}, {grid.max():.3f}] over "
              f"[-{aabb}, {aabb}]^3 — pick an --iso inside that range (lightly-trained fields are soft; try "
              f"~{0.5 * (grid.min() + grid.max()):.2f})")
    write_obj(out_path, verts, faces)
    return verts, faces


def main(argv=None) -> None:
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models import infer_model
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta
    from nerf_simple_tpu_torch.utils.device import require_device

    ap = argparse.ArgumentParser(description="Extract a triangle mesh from a trained checkpoint (PyTorch)")
    ap.add_argument("--loadpath", required=True, help="params .npz, reference .pth, ckpt_<step>.pth or exp dir")
    ap.add_argument("--out", default="mesh.obj")
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--aabb", type=float, default=2.0)
    ap.add_argument("--iso", type=float, default=1.0, help="softplus-density surface level (1/world-units)")
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)

    params = load_params(args.loadpath)  # a pair's fine net
    model = load_model_meta(args.loadpath) or infer_model(params)
    field = NerfField.from_jax_params(params, require_device(args.device), model)
    verts, faces = extract_mesh(field, args.out, R=args.resolution, aabb=args.aabb, iso=args.iso,
                                backend=args.backend,
                                compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32)
    print(f"wrote {args.out}: {len(verts)} verts, {len(faces)} faces")


if __name__ == "__main__":
    main()
