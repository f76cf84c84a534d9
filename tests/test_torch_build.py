"""The build helpers that compare a library's kernels with an earlier
commit's (kernels/_build.py: ``ptxas_usage``, ``short_name``,
``sass_against``) and the input-gradient probe's ``--before`` arguments
(probes/input_grad.py), on the CPU: no nvcc, no cuobjdump, no card."""
from pathlib import Path

import pytest

from nerf_simple_tpu_torch.kernels import _build
from nerf_simple_tpu_torch.probes import input_grad as ig_probe

LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12ig14input_grad_fmaILi32ELb0ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12ig14input_grad_fmaILi32ELb0ELb0EEEvPKf
    72 bytes stack frame, 64 bytes spill stores, 116 bytes spill loads
ptxas info    : Used 96 registers, used 5 barriers, 72 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4tileIfEvPKf' for 'sm_90a'
ptxas info    : Used 40 registers
"""


def test_ptxas_usage_pairs_each_line_with_its_kernel():
    got = _build.ptxas_usage(LOG)
    assert [k for k, _ in got] == ["_ZN12_GLOBAL__N_12ig14input_grad_fmaILi32ELb0ELb0EEEvPKf"] * 2 + ["_Z4tileIfEvPKf"]
    assert got[0][1].startswith("72 bytes stack frame") and got[1][1].startswith("ptxas info    : Used 96 registers")


@pytest.mark.parametrize("mangled, short", [
    ("_ZN12_GLOBAL__N_12ig14input_grad_fmaILi32ELb0ELb0EEEvPKf", "2ig14input_grad_fmaILi32ELb0ELb0EEEvPKf"),
    ("_Z4tileIfEvPKf", "_Z4tileIfEvPKf"),
])
def test_short_name_drops_the_anonymous_namespace(mangled, short):
    assert _build.short_name(mangled) == short


def test_sass_against_counts_identical_replaced_new_and_differing(monkeypatch, tmp_path):
    before = tmp_path / "old" / "csrc"
    cur_so, old_so = Path("/current/fused_mlp_bwd.so"), before.parent / "build" / "fused_mlp_bwd.so"
    sass = {
        str(cur_so): {"fwd": ["FFMA R1"], "bwd": ["FFMA R2"], "input_grad_fma": ["LDS"], "input_grad_mma": ["HMMA"]},
        str(old_so.resolve()): {"fwd": ["FFMA R1"], "bwd": ["FFMA R3"], "input_grad_kernelIf": ["FFMA"],
                                "input_grad_mma": ["HMMA"]},
    }
    monkeypatch.setattr(_build, "library_path", lambda name: cur_so)
    monkeypatch.setattr(_build, "sass_by_kernel", lambda so: sass[so])
    got = _build.sass_against(str(before), ["fused_mlp_bwd"], ig_probe.SASS_REPLACED)["fused_mlp_bwd"]
    assert got == dict(identical=2, earlier=3, replaced=1, kernels=4, new=["input_grad_fma"], differ=["bwd"])
    line = ig_probe.sass_line({"fused_mlp_bwd": got})
    assert "2 of the earlier 3 identical (1 SIMT input-gradient kernels replaced), 1 new, differ: ['bwd']" in line


def test_probe_before_runs_on_the_card_only():
    with pytest.raises(RuntimeError, match="card only"):
        ig_probe.main(["--device", "cpu", "--before", "csrc"])
