"""The backward's weight-gradient sums (kernels/mlp.py::weight_grad and
its plain version) against JAX's own contraction, as the JAX package's
``_backprop_tile`` writes ``mmT_acc`` and ``dbias``
(nerf_simple_tpu/kernels/mlp.py:774-791).

Planes are made with numpy from one seed and handed to both packages. On
CPU tensors the wrapper runs its plain version; the CUDA kernel is held
to that on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: both sides round the same operands to the compute type, and
a bf16 x bf16 product is exact in f32, so only the order of the f32 sums
over a few hundred rows differs: 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.probes import wgrad

ROWS = 320  # five 64-row tiles
SUMS, FG, FA = wgrad.sums(mlp.FLAGSHIP)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
REL = 1e-5


def _planes(seed=0):
    G, A = wgrad.planes(FG, FA, ROWS, "cpu", seed)
    return G.numpy(), A.numpy()


def _jax_sums(g, a, jdt):
    """``mmT_acc`` and ``dbias`` of _backprop_tile, on G as stored."""
    g, a = jnp.asarray(g), jnp.asarray(a)
    dW = jax.lax.dot_general(g.astype(jdt), a.astype(jdt), (((1,), (1,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return np.asarray(dW), np.asarray(jnp.sum(g.astype(jdt).astype(jnp.float32), 1))


def _close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_flagship_sums_are_the_backward_task_table():
    """The probe's twelve (O, K) shapes: the packed gradients' shapes."""
    shapes = mlp._weight_shapes(mlp.FLAGSHIP)
    assert [s.name for s in SUMS] == ["Wc1", "Wcd", "Wcs", "Wp1", "Wp0", "Wsh", "Wsx",
                                      "Wt4", "Wt3", "Wt2", "Wt1", "W1"]
    for s in SUMS:
        assert shapes[s.name] == (s.O, s.K), s.name
    assert (FG, FA) == (2192, 2288)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s", SUMS, ids=[s.name for s in SUMS])
def test_weight_grad_plain_matches_jax_dot_general(s, dt, jdt):
    G, A = _planes()
    g, a = G[s.gf : s.gf + s.O], A[s.af : s.af + s.K]
    dW, db = mlp.weight_grad_plain(torch.from_numpy(g), torch.from_numpy(a), dt)
    want_dW, want_db = _jax_sums(g, a, jdt)
    assert dW.dtype == db.dtype == torch.float32
    _close(dW, want_dW)
    _close(db, want_db)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_weight_grad_on_cpu_is_the_plain_version(dt, bias):
    G, A = _planes(1)
    s = SUMS[2]  # Wcs: O = 136, K = 256
    g, a = torch.from_numpy(G[s.gf : s.gf + s.O]).to(dt), torch.from_numpy(A[s.af : s.af + s.K]).to(dt)
    before = mlp.weight_grad.launches
    dW, db = mlp.weight_grad(g, a, bias)
    assert mlp.weight_grad.launches == before  # CPU tensor: no launch
    want_dW, want_db = mlp.weight_grad_plain(g, a, dt)
    assert torch.equal(dW, want_dW) and dW.dtype == torch.float32
    assert torch.equal(db, want_db) if bias else db is None


def test_bf16_sums_round_the_operands():
    """The bf16 sums are those of the rounded planes, not of f32 ones."""
    G, A = _planes(2)
    g, a = torch.from_numpy(G[:256]), torch.from_numpy(A[:72])
    got = mlp.weight_grad_plain(g, a, torch.bfloat16)[0]
    exact = mlp.weight_grad_plain(g.bfloat16().float(), a.bfloat16().float(), torch.float32)[0]
    assert torch.equal(got, exact)
    assert (got - mlp.weight_grad_plain(g, a, torch.float32)[0]).abs().max() > 1e-4


def _bad(case):
    g, a = torch.zeros(8, 128), torch.zeros(16, 128)
    return {
        "rows-not-64": (torch.zeros(8, 100), torch.zeros(16, 100)),
        "no-rows": (torch.zeros(8, 0), torch.zeros(16, 0)),
        "rows-differ": (g, torch.zeros(16, 192)),
        "O-too-wide": (torch.zeros(257, 128), a),
        "K-too-wide": (g, torch.zeros(257, 128)),
        "K-empty": (g, torch.zeros(0, 128)),
        "mixed-types": (g, a.bfloat16()),
        "f64": (g.double(), a.double()),
        "not-contiguous": (torch.zeros(128, 8).T, a),
        "one-dim": (torch.zeros(128), a),
    }[case]


@pytest.mark.parametrize("case", ["rows-not-64", "no-rows", "rows-differ", "O-too-wide", "K-too-wide",
                                  "K-empty", "mixed-types", "f64", "not-contiguous", "one-dim"])
def test_weight_grad_rejects_what_the_kernel_does_not_take(case):
    g, a = _bad(case)
    with pytest.raises(ValueError):
        mlp.weight_grad(g, a)


def test_weight_grad_raises_on_other_devices():
    with pytest.raises(ValueError, match="device"):
        mlp.weight_grad(torch.zeros(8, 128, device="meta"), torch.zeros(16, 128, device="meta"))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_weight_grads_on_cpu_are_the_plain_version(dt):
    """The twelve sums at once, as the backward runs them."""
    G, A = (torch.from_numpy(p).to(dt) for p in _planes(3))
    pairs = [(G[s.gf : s.gf + s.O], A[s.af : s.af + s.K], s.bias) for s in SUMS]
    before = mlp.weight_grad.launches
    got = mlp.weight_grads(pairs)
    assert mlp.weight_grad.launches == before
    for (g, a, bias), (dW, db) in zip(pairs, got):
        want_dW, want_db = mlp.weight_grad_plain(g, a, dt)
        assert torch.equal(dW, want_dW)
        assert torch.equal(db, want_db) if bias else db is None


def _bad_group(case):
    g, a = torch.zeros(8, 128), torch.zeros(16, 128)
    return {
        "none": [],
        "thirteen": [(g, a, True)] * 13,
        "mixed-types": [(g, a, True), (g.bfloat16(), a.bfloat16(), True)],
        "mixed-rows": [(g, a, True), (torch.zeros(8, 192), torch.zeros(16, 192), True)],
        "bad-pair": [(g, a, True), (torch.zeros(8, 100), torch.zeros(16, 100), True)],
    }[case]


@pytest.mark.parametrize("case", ["none", "thirteen", "mixed-types", "mixed-rows", "bad-pair"])
def test_weight_grads_rejects_what_one_launch_does_not_take(case):
    with pytest.raises(ValueError):
        mlp.weight_grads(_bad_group(case))


def test_probe_smoke_test_on_cpu(capsys):
    """``python -m nerf_simple_tpu_torch.probes.wgrad --device cpu`` runs the
    plain sums of every plane and times nothing."""
    wgrad.main(["--device", "cpu"])
    assert "time nothing" in capsys.readouterr().out
    flops, nbytes = wgrad.work(mlp.FLAGSHIP, wgrad.ROWS, torch.bfloat16)
    assert round(flops / 1e12, 3) == 0.564 and round(nbytes / 1e9, 2) == 4.70
