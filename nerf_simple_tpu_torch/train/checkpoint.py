"""Checkpoints and params IO (port of nerf_simple_tpu/train/checkpoint.py).

A checkpoint is ``<savepath>/<exp_name>/ckpt_<step>.pth``: the full
training state (the field's params, ``{"coarse", "fine"}`` for a
hierarchical run, ``{"prop", "fine"}`` for a proposal run, and while pose
refinement or appearance codes train the JAX ``{"field", "cams", "app"}``
wrapper with the camera delta tables and the code table; Adam's state
over all of them; the step and the generator's state; an occupancy run's
grid), so a run resumes where it stopped and draws the batches it would
have drawn. After a pose freeze the checkpoint is plain-shaped again. Orbax is absent on the
card's machine, so the JAX package's Orbax directories are not read here.

Params travel as the JAX package's pytree of numpy ``(in, out)`` arrays,
so ``params_<step>.npz`` and ``.pth`` exports written by either package
load in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch

from nerf_simple_tpu_torch.models.nerf import NerfPair
from nerf_simple_tpu_torch.models.proposal import ProposalPair


def state_params(state):
    """The params pytree of a train state: the field's, wrapped as JAX's
    ``{"field", "cams", "app"}`` while camera deltas or appearance codes
    train (each key present when its table is)."""
    params = state.field.to_jax_params()
    extras = {k: getattr(state, k).tables() for k in ("cams", "app") if getattr(state, k, None) is not None}
    return {"field": params, **extras} if extras else params


def save_checkpoint(direc: str, state) -> str:
    """Write the train state; returns the path. Overwrites a checkpoint of
    the same step."""
    os.makedirs(direc, exist_ok=True)
    path = os.path.abspath(os.path.join(direc, f"ckpt_{state.step}.pth"))
    params = state_params(state)
    occ = getattr(state, "occ", None)
    torch.save({
        "step": state.step,
        "params": params,
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        **({} if occ is None else {"occ": occ.detach().cpu()}),
    }, path)
    return path


def latest_checkpoint(direc: str) -> str | None:
    """The ``ckpt_<step>.pth`` with the largest step in ``direc``, or None."""
    if not os.path.isdir(direc):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(direc)
             if (m := re.fullmatch(r"ckpt_(\d+)\.pth", name))]
    return os.path.join(direc, max(found)[1]) if found else None


def checkpoint_step(path: str) -> int:
    """The step of a ``ckpt_<step>.pth`` path, from its name."""
    return int(re.fullmatch(r"ckpt_(\d+)\.pth", os.path.basename(path)).group(1))


def checkpoint_params(path: str):
    """The params pytree of a ``ckpt_<step>.pth`` checkpoint."""
    return torch.load(path, map_location="cpu", weights_only=False)["params"]


_SCHEMES = {NerfPair: "a coarse and fine pair (hierarchical)",
            ProposalPair: "a proposal net and a main field (proposal)"}


def _scheme(params_or_field) -> str:
    """Which of the three schemes a params pytree or a field holds."""
    if isinstance(params_or_field, dict):
        kind = NerfPair if "coarse" in params_or_field else ProposalPair if "prop" in params_or_field else None
    else:
        kind = type(params_or_field)
    return _SCHEMES.get(kind, "one field")


def restore_checkpoint(path: str, state) -> None:
    """Load a checkpoint into ``state`` (a TrainState of the same model and
    scheme: one field, a coarse and fine pair, or a proposal net and a
    main field), in place. The occupancy grid is derived state (JAX
    checkpoint.py:59-90): a grid in the checkpoint restores exactly into a
    run with a grid of the same resolution; a run with occupancy keeps its
    fresh grid when the checkpoint has none or one of another resolution
    (the run's resolution wins); a run without occupancy drops the
    checkpoint's."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    params = ck["params"]
    for key, what, knob in (("cams", "camera deltas", "`pose_opt`, and a resume past `pose_freeze_at`"),
                            ("app", "appearance codes", "`appearance_dim`")):
        table = getattr(state, key, None)
        held = "field" in params and key in params
        if held != (table is not None):
            raise ValueError(f"{path} {'holds' if held else 'has no'} {what}; the run trains "
                             f"{'them' if table is not None else 'none'} (check {knob})")
        if table is not None:
            table.copy_tables_(params[key])
    if "field" in params:
        params = params["field"]
    held, trained = _scheme(params), _scheme(state.field)
    if held != trained:
        raise ValueError(f"{path} holds {held}; the run trains {trained} (check `hierarchical` and "
                         "`proposal`)")
    state.field.copy_jax_params_(params)
    state.optimizer.load_state_dict(ck["optimizer"])
    state.generator.set_state(ck["generator"])
    state.step = int(ck["step"])
    occ = ck.get("occ")
    if occ is not None and getattr(state, "occ", None) is not None and occ.shape == state.occ.shape:
        state.occ = occ.to(state.occ.device, state.occ.dtype)


def save_model_meta(direc: str, model) -> str:
    """``model.json`` in the experiment dir, so eval and the server
    rebuild the exact model."""
    os.makedirs(direc, exist_ok=True)
    path = os.path.join(direc, "model.json")
    with open(path, "w") as fh:
        json.dump({"family": "nerf", **dataclasses.asdict(model)}, fh, indent=1)
    return path


def load_model_meta(loadpath: str):
    """The model of the ``model.json`` sidecar beside a loadpath (the
    file's directory, or the directory itself and its parent), or None."""
    from nerf_simple_tpu_torch.models import model_from_meta

    if os.path.isdir(loadpath):
        cand_dirs = [loadpath, os.path.dirname(os.path.abspath(loadpath))]
    else:
        cand_dirs = [os.path.dirname(os.path.abspath(loadpath))]
    for d in cand_dirs:
        p = os.path.join(d, "model.json")
        if os.path.exists(p):
            with open(p) as fh:
                return model_from_meta(json.load(fh))
    return None


def export_params_npz(path: str, params) -> None:
    """One npz with ``<layer>/w`` and ``<layer>/b`` arrays (nested dicts
    such as coarse/fine or prop/fine become prefixes)."""
    flat = {}

    def add(prefix, p):
        for k, v in p.items():
            if isinstance(v, dict):
                add(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    add("", params)
    np.savez(path, **flat)


def import_params_npz(path: str):
    """Inverse of export_params_npz."""
    with np.load(path) as data:
        nested: dict = {}
        for key in data.files:
            parts = key.split("/")
            d = nested
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = data[key]
    return nested


# The reference's torch.save(net.state_dict()) format (train.py:84-91):
# our layer names vs the reference Nerf module's children
# (utils/nets.py:16-32); weights transpose between (in, out) and (out, in).
_PTH_LAYER_MAP = {
    "trunk0": "layers_0.0",
    "trunk1": "layers_0.2",
    "trunk2": "layers_0.4",
    "trunk3": "layers_0.6",
    "trunk4": "layers_0.8",
    "skip": "skip_conn_layer.0",
    "post0": "layers_1.0",
    "post1": "layers_1.2",
    "sigma": "sigma_fc.0",
    "feature": "layers_2",
    "color0": "color_fc.0",
    "color1": "color_fc.2",
}


def export_params_pth(path: str, params) -> None:
    """A state_dict .pth that loads into the reference ``Nerf`` module
    with ``strict=True``. Takes one network's params: a hierarchical or
    proposal run exports its fine net (``params["fine"]``)."""
    if ("coarse" in params or "prop" in params) and "trunk0" not in params:
        raise ValueError(
            ".pth export is per-network; pass params['fine'] (or "
            "params['coarse']; the reference has no two-network format)"
        )
    sd = {}
    for ours, theirs in _PTH_LAYER_MAP.items():
        sd[f"{theirs}.weight"] = torch.from_numpy(
            np.asarray(params[ours]["w"], np.float32).T.copy()
        )
        sd[f"{theirs}.bias"] = torch.from_numpy(
            np.asarray(params[ours]["b"], np.float32).copy()
        )
    torch.save(sd, path)


def import_params_pth(path: str):
    """A reference state_dict .pth -> params pytree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for ours, theirs in _PTH_LAYER_MAP.items():
        w = sd.pop(f"{theirs}.weight").numpy()
        b = sd.pop(f"{theirs}.bias").numpy()
        params[ours] = {"w": np.ascontiguousarray(w.T), "b": b}
    if sd:
        raise ValueError(f"unrecognized keys in state_dict: {sorted(sd)}")
    return params
