"""Eval-side weight loading (port of nerf_simple_tpu/evaluate.py::load_params).

Stills and orbit videos are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations


def load_params(loadpath: str):
    """Numpy params pytree from an npz export or a reference .pth.
    ``{"field", ...}`` wrappers (pose/appearance training) unwrap to the
    field; ``{coarse, fine}`` checkpoints to the fine net."""
    if loadpath.endswith(".npz"):
        from nerf_simple_tpu_torch.train.checkpoint import import_params_npz

        params = import_params_npz(loadpath)
    elif loadpath.endswith((".pth", ".pt")):
        from nerf_simple_tpu_torch.train.checkpoint import import_params_pth

        params = import_params_pth(loadpath)
    else:
        raise NotImplementedError(
            f"{loadpath!r}: Orbax checkpoint directories are not readable "
            "without orbax; export the params to .npz or .pth first "
            "(ROADMAP Queue A, checkpoint full state)"
        )
    if isinstance(params, dict) and "field" in params:
        params = params["field"]
    if "fine" in params:
        params = params["fine"]
    return params
