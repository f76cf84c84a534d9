"""The padding probe (B4) on CPU: the plain recurrence of
nerf_simple_tpu_torch/probes/pad_passes.py against the JAX probe's Pallas
kernel (scripts/pad_passes_probe.py::_kernel) in interpret mode, the
wrapper's dispatch and the CLI's CPU smoke test.

Tolerance: both round the same operands to bf16 and sum exact products in
f32, in other orders: 1e-5 of the largest output. The CUDA kernel is held
to the plain version on the card (tests/test_torch_cuda.py, chip_smoke).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_simple_tpu_torch.probes import pad_passes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "pad_passes_probe", os.path.join(REPO, "scripts", "pad_passes_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("K", [40, 72])
def test_plain_probe_matches_jax_kernel(K):
    reps, TR = 2, 128
    x, W = pad_passes.inputs(K, TR, "cpu")
    before = pad_passes.pad_passes.launches
    got = pad_passes.pad_passes(x, W, reps).numpy()
    assert pad_passes.pad_passes.launches == before  # CPU tensor: the plain version, no launch
    probe = _jax_probe()
    probe.TR = TR  # the kernel's accumulator width, a module constant there
    want = np.asarray(pl.pallas_call(
        functools.partial(probe._kernel, reps),
        in_specs=[pl.BlockSpec((K, TR), lambda: (0, 0)), pl.BlockSpec((probe.M, K), lambda: (0, 0))],
        out_specs=pl.BlockSpec((probe.M, TR), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((probe.M, TR), jnp.float32),
        interpret=True,
    )(jnp.asarray(x.numpy()), jnp.asarray(W.numpy())))
    assert got.shape == want.shape == (256, TR)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the recurrence: two steps are twice one step's product (acc[:K] * 1e-20 vanishes)
    np.testing.assert_allclose(got, 2 * pad_passes.pad_passes_plain(x, W, 1).numpy(), rtol=1e-6)


def test_probe_wrapper_rejects_bad_inputs():
    x, W = pad_passes.inputs(72, 64, "cpu")
    with pytest.raises(ValueError, match="W must be"):
        pad_passes.pad_passes(x, W[:, :40].contiguous(), 2)
    with pytest.raises(ValueError, match="K <= 128"):
        pad_passes.pad_passes(torch.zeros(136, 64), torch.zeros(256, 136), 2)
    with pytest.raises(ValueError, match="reps"):
        pad_passes.pad_passes(x, W, -1)
    with pytest.raises(ValueError, match="device"):
        pad_passes.pad_passes(x.to("meta"), W.to("meta"), 2)


def test_probe_cli_cpu_smoke(capsys):
    pad_passes.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "CPU smoke test only" in out and "K=[40, 72, 80, 128]" in out
    assert "ms" not in out  # no times from a CPU run
