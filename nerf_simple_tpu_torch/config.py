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


def _check_dataset(dataset: str) -> None:
    """The scene loaders: "blender" and "tiny_nerf"; LLFF is not ported."""
    if dataset == "llff":
        raise NotImplementedError("dataset='llff' is not ported yet (ROADMAP Queue A item 6, LLFF/NDC)")
    if dataset not in ("blender", "tiny_nerf"):
        raise ValueError(f"dataset must be 'blender', 'tiny_nerf' or 'llff', got {dataset!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference keys (configs/lego.yaml)
    datapath: str
    savepath: str = "./models"
    exp_name: str = "exp"
    lr_init: float = 5e-4
    lr_final: float = 4e-4
    Nf: int = 128
    Nc: int = 64  # coarse samples a ray, live only when hierarchical=True
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
    # mip-NeRF 360's scene contraction: the model (main field and proposal
    # net) squashes all of space into the radius-2 ball before its encoder;
    # a model field, so the model.json sidecar carries it to eval. Pair it
    # with sampling_space: disparity and a far tf for unbounded scenes
    contract: bool = False
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
    # coarse + fine nets: Nc stratified samples place Nf importance
    # samples, and the fine net renders the sorted union of Nc + Nf
    hierarchical: bool = False
    # training regularisers: Gaussian noise on raw sigma (single net), a
    # masked L2 on expected depth against the scene's metric-depth
    # sidecars, the mip-NeRF 360 distortion loss in s-space
    sigma_noise: float = 0.0
    depth_loss_weight: float = 0.0
    distortion_loss_weight: float = 0.0
    # proposal sampling (mip-NeRF 360): a density-only ProposalMLP(prop_Lp,
    # prop_D, prop_H) probed at Np stratified samples places the Nf samples
    # of the main field, and the interlevel loss (times
    # proposal_loss_weight) distils it from the main field's weights; for
    # the first prop_anneal_frac * num_iters steps the placing histogram
    # is raised to a power ramping 0 -> 1
    proposal: bool = False
    Np: int = 64
    prop_Lp: int = 6
    prop_D: int = 4
    prop_H: int = 64
    proposal_loss_weight: float = 1.0
    prop_anneal_frac: float = 0.0
    # mip-NeRF cone casting: every sample is a conical frustum between two
    # of Nf + 1 edges, encoded by the integrated positional encoding;
    # mip_levels: 2 renders a coarse and a fine level with one network, the
    # fine edges resampled from the coarse weights (resample_blur the
    # padding), the loss mip_coarse_weight * coarse + fine;
    # opaque_background makes the last interval absorb what is left; with
    # proposal: true (mip_levels: 1) the proposal's interval histogram over
    # Np + 1 probe edges places the Nf + 1 fine edges, mip-NeRF 360's model
    mip: bool = False
    mip_levels: int = 1
    mip_coarse_weight: float = 0.1
    resample_blur: float = 0.01
    opaque_background: bool = False
    # mip-NeRF's multiscale training (paper sec. 4): the ray pool is the
    # union of the train images' 1, 1/2, 1/4 and 1/8 pyramid, each ray with
    # its cone radius and its footprint-area loss weight
    # (data/dataset.py::multiscale_train_arrays); eval and checkpoints are
    # unchanged
    mip_multiscale: bool = False
    # BARF-style camera-pose refinement: per-train-image se(3) deltas (an
    # axis-angle rotation about the camera centre and a world translation)
    # refine every sampled ray and train through ray generation, on their
    # own Adam schedule (pose_lr_init -> pose_lr_final, exponential), at lr
    # 0 for the first pose_warmup steps; pose_freeze_at bakes them into the
    # ray set (<exp_dir>/cam_deltas.npz keeps them) and the run finishes as
    # the plain config, on the fused train step; pe_anneal_until ramps the
    # encoder's octaves in (BARF's coarse-to-fine windows), done at that step
    pose_opt: bool = False
    pose_lr_init: float = 1e-3
    pose_lr_final: float = 1e-5
    pose_warmup: int = 300
    pose_freeze_at: int = 0
    pe_anneal_until: int = 0
    # NeRF-W-style appearance codes: a trainable (train images,
    # appearance_dim) table, zero at the start, on the main learning-rate
    # schedule; each ray's image's code conditions the colour head only.
    # Eval renders the mean code, or one image's (TestConfig.appearance_idx)
    appearance_dim: int = 0
    # sample the training rays from these train images only (a random
    # listed image, then a random pixel of it): the reference's
    # commented-out select_imgs mode (train.py:48). Empty: the whole split
    train_im_idxs: tuple[int, ...] = ()
    # the scene loader: "blender" (nerf_synthetic layout) or "tiny_nerf"
    # (tiny_nerf_data.npz); "llff" is not ported
    dataset: str = "blender"
    # occupancy-grid sampling (ops/occupancy.py): an (occ_R)^3 EMA grid of
    # cell opacities over [-occ_aabb, occ_aabb]^3, refreshed every
    # occ_update_every steps (decay occ_decay) from one density probe of the
    # field, places each ray's samples by inverse CDF over occ_Nb probe bins
    # (occ_floor the least mass a bin keeps); off: stratified sampling
    occupancy: bool = False
    occ_R: int = 64
    occ_Nb: int = 64
    occ_update_every: int = 16
    occ_decay: float = 0.95
    occ_floor: float = 0.01
    occ_aabb: float = 4.0
    # a directory: trace the two chunks after the first with torch.profiler
    # (utils/profiling.py) into a Chrome trace there
    profile_dir: str = ""
    # check the loss, every gradient and every updated parameter of each step
    # for NaN/Inf and raise naming the first (utils/guards.py)
    debug_nan: bool = False

    def __post_init__(self):
        for name in ("batch_size", "Nf", "num_iters", "steps_per_call",
                     "ckpt_model", "ckpt_loss", "ckpt_images"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")
        if self.hierarchical and self.Nc <= 0:
            raise ValueError(
                f"hierarchical=True needs Nc > 0 coarse samples, got Nc={self.Nc}"
            )
        if self.proposal and self.hierarchical:
            raise ValueError(
                "proposal and hierarchical are alternative sampling schemes (proposal replaces "
                "the coarse NeRF with a tiny density MLP); enable at most one"
            )
        if self.proposal and self.Np <= 0:
            raise ValueError(f"proposal=True needs Np > 0 probe samples, got Np={self.Np}")
        if self.proposal and min(self.prop_Lp, self.prop_D, self.prop_H) <= 0:
            raise ValueError(
                "proposal MLP dims must be positive, got "
                f"prop_Lp={self.prop_Lp} prop_D={self.prop_D} prop_H={self.prop_H}"
            )
        if self.proposal_loss_weight < 0:
            raise ValueError(f"proposal_loss_weight must be >= 0, got {self.proposal_loss_weight}")
        if not 0.0 <= self.prop_anneal_frac <= 1.0:
            raise ValueError(
                f"prop_anneal_frac must be in [0, 1] (fraction of num_iters), got {self.prop_anneal_frac}"
            )
        if self.prop_anneal_frac > 0 and not self.proposal:
            raise ValueError(
                "prop_anneal_frac > 0 anneals proposal-guided sample placement and needs proposal=True"
            )
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
        if self.sigma_noise < 0:
            raise ValueError(f"sigma_noise must be >= 0, got {self.sigma_noise}")
        if self.depth_loss_weight < 0:
            raise ValueError(f"depth_loss_weight must be >= 0, got {self.depth_loss_weight}")
        if self.distortion_loss_weight < 0:
            raise ValueError(f"distortion_loss_weight must be >= 0, got {self.distortion_loss_weight}")
        # the JAX TrainConfig's mip rules (nerf_simple_tpu/config.py:335-390, :451)
        bad = [name for name, on in (("hierarchical", self.hierarchical), ("occupancy", self.occupancy)) if on]
        if self.mip and bad:
            raise ValueError(
                f"mip=True is incompatible with {', '.join(bad)}: cone casting integrates frustum VOLUMES "
                "(NerfMLP IPE only) and draws its own interval edges"
            )
        if self.sampling_space == "disparity" and self.occupancy:  # JAX config.py:434-437
            raise ValueError(
                "sampling_space='disparity' is dead under occupancy=True (the occupancy grid redistributes LINEAR "
                "bins of [tn, tf] and its aabb cannot cover an unbounded far field); drop one of the two"
            )
        if self.mip_levels not in (1, 2):
            raise ValueError(f"mip_levels must be 1 or 2, got {self.mip_levels}")
        if self.resample_blur < 0:
            raise ValueError(f"resample_blur must be >= 0, got {self.resample_blur}")
        if self.opaque_background and not self.mip:
            raise ValueError(
                "opaque_background modifies INTERVAL compositing and needs mip=True (the point path "
                "already has the 1e10 tail absorber built in)"
            )
        if self.mip_levels == 2 and not self.mip:
            raise ValueError("mip_levels=2 (coarse+fine cone casting) requires mip=True")
        if self.mip_levels == 2 and self.proposal:
            raise ValueError(
                "mip_levels=2 and proposal=True both define the coarse level (shared-MLP cone "
                "resampling vs the proposal histogram); pick one"
            )
        if self.mip_levels == 2 and self.distortion_loss_weight > 0:
            raise ValueError(
                "distortion_loss_weight > 0 with mip_levels=2 is not supported (the fine level's "
                "interval edges live inside the two-level renderer)"
            )
        if self.mip_coarse_weight < 0:
            raise ValueError(f"mip_coarse_weight must be >= 0, got {self.mip_coarse_weight}")
        self._check_multiscale()
        self._check_pose()
        self._check_appearance()
        _check_dataset(self.dataset)

    def _check_multiscale(self):
        """The JAX TrainConfig's multiscale rules (nerf_simple_tpu/config.py:
        392-413, :557-560): the pyramid needs mip, no depth supervision, no
        ``train_im_idxs``, the Blender loader, and no per-image tables (pose
        deltas or appearance codes)."""
        if not self.mip_multiscale:
            return
        if not self.mip:
            raise ValueError("mip_multiscale=True (pyramid training) requires mip=True")
        if self.depth_loss_weight > 0:
            raise ValueError(
                "mip_multiscale is incompatible with depth supervision (the pyramid pixels carry no depth sidecars)")
        if self.train_im_idxs:
            raise ValueError(
                "mip_multiscale is incompatible with train_im_idxs (pyramid rays break the per-image H*W row mapping)")
        if self.dataset != "blender":
            raise ValueError(
                "mip_multiscale needs dataset=blender (the pyramid builder downsamples pinhole frames); LLFF mip uses "
                "per-ray radii instead")
        if self.appearance_dim > 0 or self.pose_opt:
            what = "appearance_dim > 0" if self.appearance_dim > 0 else "pose_opt"
            raise ValueError(
                f"{what} cannot combine with mip_multiscale: the pyramid ray pool breaks the per-image H*W row mapping")

    def _check_appearance(self):
        """The JAX TrainConfig's appearance rules (nerf_simple_tpu/config.py:
        543-572, :596-601; the family and the data-sharding rules hold by
        construction: their keys are not ported), then the port's: more
        than 8 code rows under "pallas" raise (the kernels' input has 8
        rows for the code; JAX falls back to its XLA path)."""
        if self.appearance_dim < 0:
            raise ValueError(f"appearance_dim must be >= 0, got {self.appearance_dim}")
        if self.appearance_dim == 0:
            return
        if self.mip:
            raise ValueError(
                "appearance_dim > 0 is not plumbed through the mip IPE path; use point-sampled configs "
                "(plain/hierarchical/proposal/occupancy)")
        if self.pose_freeze_at > 0:
            raise ValueError(
                "pose_freeze_at cannot combine with appearance_dim: freezing drops the per-image params "
                "wrapper, but appearance codes must stay trainable for the whole run (freeze is pose-only)")
        if self.appearance_dim > 8 and self.backend == "pallas":
            raise ValueError(
                f"appearance_dim={self.appearance_dim} > 8 under backend 'pallas': the kernels' 16-row input "
                "holds 8 code rows; use backend 'xla' (JAX falls back to it with a warning, the port raises)")

    def _check_pose(self):
        """The JAX TrainConfig's pose rules (nerf_simple_tpu/config.py:
        578-643). Pose composes with mip (one or two levels) and with
        proposal sampling, and with both (mip-NeRF 360's composition), on a
        contracted model too, as in JAX."""
        if self.pose_opt and (self.pose_lr_init <= 0 or self.pose_lr_final <= 0):
            raise ValueError(
                f"pose_lr_init/pose_lr_final must be positive, got {self.pose_lr_init}/{self.pose_lr_final}")
        if self.pose_freeze_at < 0:
            raise ValueError(f"pose_freeze_at must be >= 0, got {self.pose_freeze_at}")
        if self.pose_freeze_at > 0:
            if not self.pose_opt:
                raise ValueError("pose_freeze_at > 0 without pose_opt: there are no pose deltas to freeze")
            if self.pose_freeze_at <= self.pose_warmup:
                raise ValueError(
                    f"pose_freeze_at ({self.pose_freeze_at}) must exceed pose_warmup ({self.pose_warmup}): "
                    "pose lr is zero through the warmup, so freezing before it ends would bake untrained "
                    "(identity) deltas")
            if self.pose_freeze_at >= self.num_iters:
                raise ValueError(
                    f"pose_freeze_at ({self.pose_freeze_at}) must be < num_iters ({self.num_iters}); for "
                    "poses trained to the end just leave pose_freeze_at at 0")
        if self.pe_anneal_until < 0:
            raise ValueError(f"pe_anneal_until must be >= 0, got {self.pe_anneal_until}")
        if self.pe_anneal_until > 0:
            if not self.pose_opt:
                raise ValueError(
                    "pe_anneal_until > 0 without pose_opt: PE annealing exists to stabilize joint pose "
                    "refinement (and by itself only slows convergence)")
            if self.mip:
                raise ValueError(
                    "pe_anneal_until is not plumbed through the mip IPE encoder (IPE's variance damping "
                    "plays the same low-pass role)")
            if self.pose_freeze_at and self.pe_anneal_until > self.pose_freeze_at:
                raise ValueError(
                    f"pe_anneal_until ({self.pe_anneal_until}) must finish by pose_freeze_at "
                    f"({self.pose_freeze_at}): the post-freeze fused kernel computes the standard "
                    "full-frequency encoder")

    @property
    def render_dtype(self):
        import torch

        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32


# Keys of the JAX TrainConfig whose features are not ported yet: key ->
# (JAX default, ROADMAP item). At the default a key changes nothing.
_UNPORTED: dict[str, tuple[Any, str]] = {}
for _item, _keys in {
    "item 8, the hashgrid/cpgrid families": {
        "model_family": "nerf", "hash_L": 8, "hash_F": 4, "hash_log2_T": 14, "hash_Nmin": 16,
        "hash_Nmax": 256, "hash_H": 64, "hash_aabb": 4.0, "hash_grad_mode": "sample",
        "hash_fwd_mode": "exact", "cp_Rs": (64, 256), "cp_Cs": 32, "cp_Ca": 96, "cp_P": 27,
        "cp_H": 64, "cp_aabb": 4.0, "cp_lr_grid": 2e-2},
    "item 9, data parallelism": {"num_data_shards": 1, "distributed": False, "shard_dataset": False},
    "item 6, LLFF/NDC": {"llff_factor": 8, "ndc": True},
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
                    f"config key {k}={v!r} is not ported yet (ROADMAP Queue A {item}); "
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
    ``test_params`` section is ignored). The JAX rule on contraction with
    NDC (config.py:441-449) is checked here, where the unported ``dataset``
    and ``ndc`` keys still are: two unbounded-scene warps at once is a
    ValueError, before LLFF itself raises as unported."""
    if params.get("contract") and params.get("dataset") == "llff" and params.get("ndc", True):
        raise ValueError(
            "contract=True is redundant/incompatible with NDC (both are unbounded-scene warps); set ndc: false "
            "for contracted LLFF captures"
        )
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
    # cone-cast eval (the radius from the eval frame's focal), at one or
    # two levels, the fine level's edges resampled with resample_blur
    mip: bool = False
    mip_levels: int = 1
    resample_blur: float = 0.01
    # the JAX TestConfig accepts it without mip; here it raises (see below)
    opaque_background: bool = False
    sampling_space: str = "linear"
    compute_dtype: str = "f32"
    backend: str = "xla"
    seed: int = 0
    orbit_radius: float = 4.0  # hardcoded r=4 at test.py:33
    normals: bool = False  # also write normal_<i>.png from density gradients
    Nc: int = 0  # > 0: hierarchical eval, Nc coarse and N_samples importance samples
    Np: int = 0  # > 0: proposal eval, Np probes of the proposal net place N_samples
    # appearance checkpoints: the train image whose code conditions the
    # render, or -1 for the mean code (NeRF-W's canonical look)
    appearance_idx: int = -1
    # the scene loader, as TrainConfig.dataset
    dataset: str = "blender"
    # occupancy-informed eval: the grid rebuilt once from the loaded density
    # field, each ray's N_samples at the deterministic quantiles of its PDF;
    # occ_group > 1 shares one probe among each run of that many adjacent rays
    occupancy: bool = False
    occ_R: int = 64
    occ_Nb: int = 64
    occ_floor: float = 0.01
    occ_aabb: float = 4.0
    occ_group: int = 1

    def __post_init__(self):
        if self.Np > 0 and self.Nc > 0:
            raise ValueError(
                "Np > 0 (proposal-guided eval) and Nc > 0 (hierarchical eval) are alternative "
                "samplers; set at most one"
            )
        if self.mip and (self.Nc > 0 or self.occupancy):  # the JAX TestConfig's mip rules (config.py:736-759)
            raise ValueError(
                "mip=True (cone-cast eval) draws its own interval edges; it excludes Nc/occupancy point "
                "resampling (mip_levels: 2 is the cone-cast hierarchical scheme)"
            )
        if self.mip and self.mip_levels == 2 and self.Np > 0:
            raise ValueError("mip_levels=2 and Np > 0 both define the coarse level; pick one")
        if self.mip_levels not in (1, 2):
            raise ValueError(f"mip_levels must be 1 or 2, got {self.mip_levels}")
        if self.mip_levels == 2 and not self.mip:
            raise ValueError("mip_levels=2 (coarse+fine cone casting) requires mip=True")
        if self.opaque_background and not self.mip:
            # the JAX TrainConfig's rule (config.py:368-373), which its
            # TestConfig lacks (ROADMAP, Queue C's deliberate behaviour
            # changes)
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
        if self.sampling_space == "disparity" and self.occupancy:  # JAX config.py:781-784
            raise ValueError(
                "sampling_space='disparity' is dead under occupancy (the occupancy grid redistributes LINEAR "
                "bins of [tn, tf]); drop one of the two"
            )
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {self.compute_dtype!r}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {self.backend!r}")
        if self.batch_size <= 0 or self.N_samples <= 0 or self.num_poses <= 0:
            raise ValueError("batch_size, N_samples and num_poses must be positive")
        _check_dataset(self.dataset)

    @property
    def render_dtype(self):
        import torch

        return torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32


# Keys of the JAX TestConfig whose features are not ported yet, as
# _UNPORTED for TrainConfig. num_data_shards also takes 0 (single chip).
_TEST_UNPORTED: dict[str, tuple[Any, str]] = {}
for _item, _keys in {
    "item 9, data parallelism": {"num_data_shards": 1},
    "item 6, LLFF/NDC": {"llff_factor": 8, "ndc": True},
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
