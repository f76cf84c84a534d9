"""Training and eval configuration (port of nerf_simple_tpu/config.py::
TrainConfig and TestConfig).

The YAML keys are the JAX package's, so ``configs/lego.yaml`` loads
unchanged. ``TrainConfig`` and ``TestConfig`` hold the keys this package
runs, with the JAX defaults. A key of a feature that is not ported yet is
accepted at its JAX default and raises ``NotImplementedError`` at any
other value; any other unknown key warns, as the JAX reader does.

The card's machine has no ``yaml``, so ``load_yaml`` reads the subset of
YAML that the repo's configs use: ``key: value`` lines, one nested map
(``test_params``), inline lists, comments, and YAML 1.1 scalars resolved
as PyYAML resolves them (``True``/``yes``/``on`` are booleans, ``5e-4``
without a dot stays a string).
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference keys (configs/lego.yaml)
    datapath: str
    savepath: str = "./models"
    exp_name: str = "exp"
    lr_init: float = 5e-4
    lr_final: float = 4e-4
    Nf: int = 128
    Nc: int = 64  # read only by hierarchical sampling, which is not ported
    num_iters: int = 4000
    ckpt_model: int = 2000
    ckpt_loss: int = 100
    ckpt_images: int = 500
    batch_size: int = 4096
    half_res: bool = True
    val_idxs: tuple[int, ...] = (0, 1)
    num_train_imgs: int = 25
    # extensions of the JAX package that this package runs
    tn: float = 2.0
    tf: float = 6.0
    seed: int = 0
    honor_lr_init: bool = False  # the reference's Adam ignores lr_init
    sampling_space: str = "linear"
    white_bkgd: bool = False
    compute_dtype: str = "f32"
    backend: str = "xla"
    net_H: int = 256
    net_Lp: int = 10
    net_Ld: int = 4
    # iterations between host syncs when no log/image/checkpoint falls
    # inside them (the JAX step scans this many iterations in one call)
    steps_per_call: int = 20
    resume: bool = False
    log_dir: str = "logs"

    def __post_init__(self):
        for name in ("batch_size", "Nf", "num_iters", "steps_per_call",
                     "ckpt_model", "ckpt_loss", "ckpt_images"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")
        if self.sampling_space not in ("linear", "disparity"):
            raise ValueError(
                f"sampling_space must be 'linear' or 'disparity', got {self.sampling_space!r}"
            )
        if self.sampling_space == "disparity" and self.tn <= 0:
            raise ValueError(f"sampling_space='disparity' needs tn > 0; got tn={self.tn}")
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {self.compute_dtype!r}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {self.backend!r}")

    @property
    def render_dtype(self):
        import torch

        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32


# Keys of the JAX TrainConfig whose features are not ported yet: key ->
# (JAX default, ROADMAP item). At the default a key changes nothing.
_UNPORTED: dict[str, tuple[Any, str]] = {}
for _item, _keys in {
    "hierarchical": {"hierarchical": False},
    "proposal": {"proposal": False, "Np": 64, "prop_Lp": 6, "prop_D": 4, "prop_H": 64,
                 "proposal_loss_weight": 1.0, "prop_anneal_frac": 0.0},
    "mip": {"mip": False, "mip_levels": 1, "mip_coarse_weight": 0.1, "resample_blur": 0.01,
            "opaque_background": False, "mip_multiscale": False},
    "contract with disparity spacing": {"contract": False},
    "regularisers (sigma noise, depth, distortion)": {
        "sigma_noise": 0.0, "depth_loss_weight": 0.0, "distortion_loss_weight": 0.0},
    "pose/appearance": {"appearance_dim": 0, "pose_opt": False, "pose_lr_init": 1e-3,
                        "pose_lr_final": 1e-5, "pose_warmup": 300, "pose_freeze_at": 0,
                        "pe_anneal_until": 0, "train_im_idxs": ()},
    "the hashgrid/cpgrid families": {
        "model_family": "nerf", "hash_L": 8, "hash_F": 4, "hash_log2_T": 14, "hash_Nmin": 16,
        "hash_Nmax": 256, "hash_H": 64, "hash_aabb": 4.0, "hash_grad_mode": "sample",
        "hash_fwd_mode": "exact", "cp_Rs": (64, 256), "cp_Cs": 32, "cp_Ca": 96, "cp_P": 27,
        "cp_H": 64, "cp_aabb": 4.0, "cp_lr_grid": 2e-2},
    "occupancy": {"occupancy": False, "occ_R": 64, "occ_Nb": 64, "occ_update_every": 16,
                  "occ_decay": 0.95, "occ_floor": 0.01, "occ_aabb": 4.0},
    "data parallelism": {"num_data_shards": 1, "distributed": False, "shard_dataset": False},
    "LLFF/NDC": {"dataset": "blender", "llff_factor": 8, "ndc": True},
    "tracing and debug guards": {"profile_dir": "", "debug_nan": False},
}.items():
    _UNPORTED.update({k: (v, _item) for k, v in _keys.items()})

# keys of a full config file that belong to another section
_CROSS_SECTION_KEYS = {"test_params"}


def _filter_kwargs(cls, d: dict[str, Any], unported: dict[str, tuple[Any, str]]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        v = tuple(v) if isinstance(v, list) else v
        if k in names:
            out[k] = v
        elif k in unported:
            default, item = unported[k]
            if v != default:
                raise NotImplementedError(
                    f"config key {k}={v!r} is not ported yet (ROADMAP Queue A, {item}); "
                    f"only its JAX default {default!r} is accepted"
                )
        elif k not in _CROSS_SECTION_KEYS:
            warnings.warn(
                f"unknown config key {k!r} ignored by {cls.__name__} (check for typos; "
                f"known keys: {', '.join(sorted(names))})",
                stacklevel=3,
            )
    return out


def train_config_from_dict(params: dict[str, Any]) -> TrainConfig:
    """A TrainConfig from a reference-schema config dict (the nested
    ``test_params`` section is ignored)."""
    return TrainConfig(**_filter_kwargs(TrainConfig, params, _UNPORTED))


@dataclasses.dataclass(frozen=True)
class TestConfig:
    # reference keys (configs/lego.yaml:17-28)
    loadpath: str
    datapath: str
    savepath: str = "./results"
    exp_name: str = "exp"
    batch_size: int = 16000  # rays a render chunk (rounded up to a multiple of 1,024)
    half_res: bool = True
    im_set: str = "test"
    im_idxs: tuple[int, ...] = (0,)
    animation: bool = False
    num_poses: int = 30
    theta: float = 30.0
    # extensions of the JAX package that this package runs
    tn: float = 2.0
    tf: float = 6.0
    N_samples: int = 128  # hardcoded 128 in the reference (rendering.py:102)
    # the JAX TestConfig accepts it without mip; here it raises (see below)
    opaque_background: bool = False
    sampling_space: str = "linear"
    compute_dtype: str = "f32"
    backend: str = "xla"
    seed: int = 0
    orbit_radius: float = 4.0  # hardcoded r=4 at test.py:33
    normals: bool = False  # also write normal_<i>.png from density gradients
    appearance_idx: int = -1  # read only by appearance checkpoints, not ported

    def __post_init__(self):
        if self.opaque_background:
            # the JAX TrainConfig's rule (config.py:368-373), which its
            # TestConfig lacks (ROADMAP Queue C 3)
            raise ValueError(
                "opaque_background modifies INTERVAL compositing and "
                "needs mip=True (the point path already has the 1e10 "
                "tail absorber built in)"
            )
        if self.sampling_space not in ("linear", "disparity"):
            raise ValueError(
                f"sampling_space must be 'linear' or 'disparity', got {self.sampling_space!r}"
            )
        if self.sampling_space == "disparity" and self.tn <= 0:
            raise ValueError(
                f"sampling_space='disparity' needs tn > 0 (bins are uniform in 1/t); got tn={self.tn}"
            )
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {self.compute_dtype!r}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {self.backend!r}")
        if self.batch_size <= 0 or self.N_samples <= 0 or self.num_poses <= 0:
            raise ValueError("batch_size, N_samples and num_poses must be positive")

    @property
    def render_dtype(self):
        import torch

        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32


# Keys of the JAX TestConfig whose features are not ported yet, as
# _UNPORTED for TrainConfig. num_data_shards also takes 0 (single chip).
_TEST_UNPORTED: dict[str, tuple[Any, str]] = {}
for _item, _keys in {
    "hierarchical": {"Nc": 0},
    "proposal": {"Np": 0},
    "mip": {"mip": False, "mip_levels": 1, "resample_blur": 0.01},
    "occupancy": {"occupancy": False, "occ_R": 64, "occ_Nb": 64, "occ_floor": 0.01,
                  "occ_aabb": 4.0, "occ_group": 1},
    "data parallelism": {"num_data_shards": 1},
    "LLFF/NDC": {"dataset": "blender", "llff_factor": 8, "ndc": True},
}.items():
    _TEST_UNPORTED.update({k: (v, _item) for k, v in _keys.items()})


def test_config_from_dict(params: dict[str, Any]) -> TestConfig:
    """A TestConfig from the ``test_params`` sub-dict (or a full
    reference dict holding one)."""
    if "test_params" in params:
        params = params["test_params"]
    if params.get("num_data_shards") == 0:  # 0 and 1 both mean one chip
        params = {k: v for k, v in params.items() if k != "num_data_shards"}
    return TestConfig(**_filter_kwargs(TestConfig, params, _TEST_UNPORTED))


# --- the YAML subset --------------------------------------------------------

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan")}


def _scalar(s: str) -> Any:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if s.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[s.lower()]
    return s


def _value(s: str) -> Any:
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated inline list: {s!r}")
        inner = s[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    return _scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict[str, Any]:
    """The repo's config subset of YAML -> dict (see the module docstring)."""
    root: dict[str, Any] = {}
    nested: dict[str, Any] | None = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indented = line[0] in " \t"
        key, sep, rest = line.strip().partition(":")
        if not sep or not key:
            raise ValueError(f"line {n}: expected 'key: value', got {raw!r}")
        if indented:
            if nested is None:
                raise ValueError(f"line {n}: indented key outside a nested map")
            nested[key] = _value(rest)
        elif rest.strip():
            root[key], nested = _value(rest), None
        else:
            nested = root[key] = {}
    return root


def load_yaml(path: str) -> dict[str, Any]:
    with open(path) as fh:
        return parse_yaml(fh.read())
