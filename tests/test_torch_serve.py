"""The port's serving slice on CPU: render_rays against the JAX renderer
(its Pallas kernel in interpret mode), the chunked render, and the HTTP
server over a real socket (mirrors tests/test_serve.py)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.render.renderer as jrender
from nerf_simple_tpu_torch.kernels.mlp import fused_mlp_forward
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
from nerf_simple_tpu_torch.render.renderer import (
    RenderSettings,
    render_rays,
    render_rays_chunked,
)
from nerf_simple_tpu_torch.serve import RenderServer, decode_png, encode_png, main, serve

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
FH, FW, FOCAL, N = 16, 24, 20.0, 8  # non-square: catches H/W transpositions


def _frame_rays(phi=45.0):
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, phi)[None], dtype=torch.float32)
    return rays_for_poses(pose, FH, FW, FOCAL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_slice_matches_jax_render(backend):
    """A 16x24 frame through JAX render_rays (pallas backend, interpret
    mode) and the port's render_rays at the same injected ts."""
    params = init_nerf_params(0, SMALL)
    field = NerfField.from_jax_params(params, "cpu")
    rays = _frame_rays()
    rng = np.random.default_rng(1)
    ts = np.sort(rng.uniform(2.0, 6.0, (rays.shape[0], N)), axis=-1).astype(np.float32)
    jparams = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}
    with pltpu.force_tpu_interpret_mode():
        want = jrender.render_rays(
            jparams, jnp.asarray(rays.numpy()), jax.random.PRNGKey(0),
            jrender.RenderSettings(N=N, backend="pallas"), jnerf.NerfMLP(4, 2, 32),
            ts=jnp.asarray(ts),
        )
    got = render_rays(field, rays, None, RenderSettings(N=N, backend=backend), ts=torch.from_numpy(ts))
    np.testing.assert_allclose(got.rgb.detach().numpy(), np.asarray(want.rgb), atol=1e-4)
    np.testing.assert_allclose(got.disp.detach().numpy(), np.asarray(want.disp), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.weights.detach().numpy(), np.asarray(want.weights), atol=1e-4)


def test_chunked_equals_unchunked_and_pads_with_last_ray():
    field = NerfField.from_jax_params(init_nerf_params(1, SMALL), "cpu")
    rays = _frame_rays()[:100]
    s = RenderSettings(N=N, backend="pallas")
    whole_rgb, whole_disp = render_rays_chunked(field, rays, 3, s, chunk=128)
    # one chunk of 128 holds all 100 rays (28 copies of the last ray):
    # the same samples as rendering the padded batch directly
    from nerf_simple_tpu_torch.render.renderer import chunk_generator

    padded = torch.cat([rays, rays[-1:].expand(28, 6)])
    direct = render_rays(field, padded, chunk_generator(3, 0, "cpu"), s)
    assert whole_rgb.shape == (100, 3) and whole_disp.shape == (100,)
    torch.testing.assert_close(whole_rgb, torch.clamp(direct.rgb[:100], 0, 1))
    torch.testing.assert_close(whole_disp, direct.disp[:100])
    # padded rows are copies of the last ray, so they render like it up to
    # their own jitter: finite, and identical at deterministic samples
    det = render_rays(field, padded, None, s, ts=torch.linspace(2.5, 5.5, N).expand(128, N))
    assert torch.equal(det.rgb[99:], det.rgb[99:100].expand(29, 3))
    # chunking changes only which generator a ray's samples come from:
    # at several chunks the frame stays finite and in range
    rgb4, disp4 = render_rays_chunked(field, rays, 3, s, chunk=32)
    assert rgb4.shape == (100, 3) and torch.isfinite(disp4).all()
    assert float(rgb4.min()) >= 0.0 and float(rgb4.max()) <= 1.0
    again = render_rays_chunked(field, rays, 3, s, chunk=32)[0]
    assert torch.equal(rgb4, again)  # seeded per (seed, chunk): reproducible


def test_render_settings_reject_unported():
    for kw in ({"N_prop": 32, "mip": True}, {"mip": True, "mip_shape": "cylinder"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            RenderSettings(**kw)
    assert RenderSettings(N_prop=32).N_prop == 32  # ported: proposal sampling
    assert RenderSettings(mip=True, mip_levels=2).mip_levels == 2  # ported: cone casting
    assert RenderSettings(sigma_noise=1.0).sigma_noise == 1.0  # ported: a training regulariser
    assert RenderSettings(fused_eval=True, backend="pallas").fused_eval  # the fused render kernel
    with pytest.raises(ValueError, match="backend"):
        RenderSettings(backend="cuda")
    field = NerfField.from_jax_params(init_nerf_params(0, SMALL), "cpu")
    with pytest.raises(NotImplementedError, match="occupancy"):
        render_rays_chunked(field, _frame_rays(), 0, RenderSettings(N=N), occ=torch.zeros(4, 4, 4))


def test_png_round_trip():
    frame = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    data = encode_png(frame)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), frame)
    with pytest.raises(ValueError, match="CRC"):
        decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])


@pytest.fixture(scope="module")
def tiny_server():
    srv = RenderServer(
        init_nerf_params(0, SMALL), FH, FW, FOCAL, RenderSettings(N=N, backend="pallas"),
        warmup=False, device="cpu",
    )
    httpd = serve(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def test_health_reports_model_and_device(tiny_server):
    srv, url = tiny_server
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["frame"] == [FH, FW]
    assert body["model"] == "NerfMLP" and body["arch"]["Lp"] == 4 and body["arch"]["H"] == 32
    assert body["backend"] == "pallas" and body["device"] == "cpu"
    assert body["kernel_launches"] == fused_mlp_forward.launches


def test_render_returns_png(tiny_server):
    srv, url = tiny_server
    before = fused_mlp_forward.launches
    with urllib.request.urlopen(url + "/render?r=4&theta=-30&phi=45", timeout=120) as r:
        assert r.headers["Content-Type"] == "image/png"
        img = decode_png(r.read())
    assert img.shape == (FH, FW, 3)
    np.testing.assert_array_equal(img, srv.render(4.0, -30.0, 45.0))
    assert fused_mlp_forward.launches == before  # CPU: the plain version, no kernel launch


def test_unknown_path_404(tiny_server):
    _, url = tiny_server
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert ei.value.code == 404


@pytest.mark.parametrize(
    "flag", [["--occupancy"], ["--proposal-samples", "32", "--mip"], ["--mip", "--occupancy"],
             ["--mip", "--mip-levels", "2", "--occ-R", "32"], ["--mip", "--opaque-background", "--proposal-samples", "8"],
             ["--occ-R", "32"], ["--mip", "--resample-blur", "0.1", "--proposal-samples", "8"]],
)
def test_cli_rejects_unported_flags(flag):
    base = ["--loadpath", "x.npz", "--height", "4", "--width", "4", "--focal", "5"]
    with pytest.raises(NotImplementedError, match="not ported"):
        main(base + flag)
