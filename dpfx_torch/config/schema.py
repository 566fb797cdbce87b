"""Config system: dataclass schema + YAML loader (SURVEY.md §2 C1, §8 step 1).

One YAML file per experiment, mirroring the reference's config-per-experiment
layout (SURVEY.md §1 L5). The loader is *forgiving by default*: unknown keys
are collected into `Config.extra` and warned about rather than rejected, so
that reference-format YAMLs load without modification ("reference-compat
mode", SURVEY.md §5 config bullet). Pass ``strict=True`` to reject unknown
keys instead.

Hyperparameter defaults marked ``VERIFY-vs-reference`` are paper-plausible
values (arXiv:2007.10170) that could not be checked against the reference
configs because the mount was empty (SURVEY.md §0, §8 hard-part 5).

This is the port's own copy of ``dpfx/config/schema.py`` (the port imports
nothing of the JAX package), so the same YAMLs load into both. Knobs that
only the JAX build reads (``train.flat_optimizer``: the port's optimizer is
always flat; ``parallel.axis_name``, ...) are accepted and ignored by the
port; ``train.steps_per_call`` (K steps a call, replays of a step captured
in a CUDA graph), ``data.device_resident`` and the rest of ``parallel``
(one process per GPU over ``torch.distributed``: ``dpfx_torch.parallel``)
are honoured.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


def _build(cls, data: Dict[str, Any], strict: bool, path: str):
    """Construct dataclass ``cls`` from a dict, recursing into nested
    dataclass fields; unknown keys go to an ``extra`` dict field if the class
    has one, else warn/raise."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"config section {path!r} must be a mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    unknown: list = []
    for key, value in data.items():
        if key == "extra" and isinstance(value, dict):
            # round-trip support: config_to_dict serializes .extra as a key;
            # not an unknown key, so no warning
            extra.update(value)
            continue
        if key in fields and key != "extra":
            f = fields[key]
            sub = _dataclass_type(f.type, cls)
            if sub is not None:
                kwargs[key] = _build(sub, value, strict, f"{path}.{key}")
            else:
                kwargs[key] = _coerce(value, f)
        else:
            extra[key] = value
            unknown.append(key)
    if unknown:
        if strict:
            raise KeyError(f"unknown config keys at {path!r}: {sorted(unknown)}")
        warnings.warn(
            f"dpfx.config: unknown keys at {path!r} kept in .extra: {sorted(unknown)}",
            stacklevel=2,
        )
    obj = cls(**kwargs)
    if "extra" in fields:
        object.__setattr__(obj, "extra", extra)
    elif extra:
        pass  # warned above; dropped
    return obj


_TYPE_REGISTRY: Dict[str, type] = {}


def _dataclass_type(tp, owner) -> Optional[type]:
    """Resolve a field annotation (possibly a string under future-annotations)
    to a dataclass type, or None for plain fields."""
    if isinstance(tp, str):
        tp = _TYPE_REGISTRY.get(tp.strip("'\""))
    if tp is not None and dataclasses.is_dataclass(tp):
        return tp
    return None


def _coerce(value, f: dataclasses.Field):
    # YAML gives ints where floats are annotated (lr: 1 etc.) — normalize.
    ann = f.type if not isinstance(f.type, str) else f.type
    if isinstance(value, int) and not isinstance(value, bool):
        if ann in (float, "float", "Optional[float]"):
            return float(value)
    if isinstance(value, list):
        return tuple(value) if "Tuple" in str(ann) or "tuple" in str(ann) else value
    return value


@dataclass
class FlowConfig:
    """Discrete affine-coupling flow hyperparameters (SURVEY.md §7).

    Used for both the conditional point flow (decoder, C6) and the
    unconditional latent prior flow (C7).
    """

    n_layers: int = 32          # VERIFY-vs-reference: K, "tens of layers" [paper]
    hidden: int = 128           # VERIFY-vs-reference: conditioner MLP width
    n_hidden: int = 2           # VERIFY-vs-reference: conditioner hidden depth
    activation: str = "relu"    # relu | gelu | tanh; VERIFY-vs-reference.
    #                             relu default: the plausible torch-research
    #                             choice AND 1.6x faster on TPU (gelu's tanh
    #                             chain is pure VPU time: 29.5 -> 18.3 ms
    #                             flagship grad step, BASELINE.md round 2)
    use_actnorm: bool = False   # VERIFY-vs-reference: actnorm presence unknown (SURVEY §9.3)
    scale_cap: float = 8.0      # |log-scale| soft cap via tanh for numerical stability
    # conditioner matmul dtype; coupling arithmetic + log-det stay f32, and
    # inverse recomputes the identical (s, t), so invertibility is exact at
    # any compute dtype. bfloat16 doubles MXU throughput on the sampling path.
    compute_dtype: str = "float32"  # float32 | bfloat16
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EncoderConfig:
    """PointNet-style posterior encoder q(z|X) (SURVEY.md §2 C5)."""

    point_widths: Tuple[int, ...] = (128, 128, 256, 512)  # VERIFY-vs-reference
    head_widths: Tuple[int, ...] = (256,)                 # VERIFY-vs-reference
    activation: str = "relu"                              # relu | gelu | tanh
    compute_dtype: str = "float32"                        # float32 | bfloat16
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ImageEncoderConfig:
    """SVR image encoder (SURVEY.md §2 C8). Backbone choice LOW conf;
    `conv` (reference-style ResNet, the default) vs `mixer` (TPU-native
    pure-matmul alternative). Round 1 defaulted to mixer because conv
    grads compiled pathologically through this box's remote TPU compiler;
    re-measured in round 2 at ~145 s total compile + 16 ms/step — normal —
    so the default returned to the reference-faithful backbone."""

    arch: str = "conv"                             # conv | mixer; VERIFY-vs-reference
    widths: Tuple[int, ...] = (32, 64, 128, 256)  # conv stages; VERIFY-vs-reference
    blocks_per_stage: int = 2                      # conv
    patch: int = 8                                 # mixer
    width: int = 256                               # mixer
    depth: int = 4                                 # mixer
    image_size: int = 128                          # VERIFY-vs-reference
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    dz: int = 128               # VERIFY-vs-reference: latent dim "order 64-128"
    point_flow: FlowConfig = field(default_factory=lambda: FlowConfig())
    latent_flow: FlowConfig = field(
        default_factory=lambda: FlowConfig(n_layers=14, hidden=256, n_hidden=2)
    )
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    image_encoder: ImageEncoderConfig = field(default_factory=ImageEncoderConfig)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    dataset: str = "synthetic"   # synthetic | synthetic_svr | shapenet_h5 |
    #                              shapenet_npy_dir | shapenet_svr
    path: str = ""
    render_path: str = ""        # SVR rendering root (shapenet_svr)
    views_per_model: int = 24    # renders per model in the 3D-R2N2 tree;
    #                              VERIFY-vs-reference (SURVEY.md §9.6)
    packed_path: str = ""        # packed [S,N,3] .npy for the native C++ loader
    #                              (tools/pack_dataset.py); train-split only
    category: str = "airplane"   # or "all"
    n_points: int = 2048         # training cloud size [paper, HIGH]
    n_points_eval: int = 2048
    normalize: str = "per_shape"  # per_shape | global | none; VERIFY-vs-reference (§7 metric conventions)
    # category-name -> label-id map for shapenet_h5 files that carry labels
    # but no name table; never guessed (round-1 ADVICE)
    h5_label_map: Dict[str, int] = field(default_factory=dict)
    norm_stats_max_clouds: int = 0  # 0 = full train split (PointFlow frame);
    #                                 >0 = seeded random subsample (warned)
    norm_stats_seed: int = 0
    num_workers: int = 0
    # upload the whole (normalized) train split to HBM once and batch ON
    # DEVICE inside the jitted step — zero host->device data traffic in
    # steady state (dpfx/data/device.py). Point-modality experiments with
    # splits that fit HBM (ShapeNet airplane @ 15k pts ~ 0.5 GB).
    device_resident: bool = False
    resident_draw: str = "epoch"  # epoch | iid. Default is the host-loader /
    #   reference convention (SURVEY.md §3.1): a per-epoch permutation of
    #   the split walked in batches, derived ON DEVICE from the absolute
    #   step — resident loss curves are step-comparable with an epoch-walk
    #   reference run. "iid" (the pre-round-5 default) draws uniform per
    #   step: statistically immaterial for the i.i.d. ELBO objective at
    #   these split sizes, but not epoch-comparable; kept as an option for
    #   continuity with recorded round-3/4 runs.
    # synthetic dataset controls (tests / smoke configs)
    synthetic_size: int = 256
    synthetic_modes: int = 4
    synthetic_family: str = "v1"  # v1 (sphere/box/blobs golden-fixture family)
    #                               | v2 (continuous rotated-surface family for
    #                               generalization-quality runs)
    #                               | v3 (compositional multi-part family:
    #                               variable part counts + thin structures;
    #                               round-4 quality benchmark — v2 saturated)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainConfig:
    batch_size: int = 32
    steps: int = 10_000
    epochs: int = 0              # reference-style epoch count; when > 0 the
    #                              CLI derives steps = epochs * len(train)/B
    lr: float = 1e-3             # VERIFY-vs-reference
    lr_schedule: str = "cosine"  # cosine | constant | step
    lr_decay_steps: int = 0      # 0 -> use `steps`
    lr_min_ratio: float = 0.01
    lr_warmup_steps: int = 0     # linear warmup prefix; VERIFY-vs-reference
    weight_decay: float = 0.0
    grad_clip: float = 10.0      # 0 disables; flows blow up without it
    #                              (gnorm ~8k observed; VERIFY-vs-reference)
    seed: int = 0
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 1000
    ckpt_keep: int = 3    # orbax max_to_keep; 0 = keep every checkpoint
    #                       (long-horizon quality runs eval non-final steps)
    eval_every: int = 1000
    log_every: int = 100
    loss: str = "elbo"           # elbo (AE/gen); recon-only variants for ablation
    tensorboard: bool = False    # clu.metric_writers TB events next to metrics.jsonl
    steps_per_call: int = 1      # >1: K train steps a call (the JAX build: one
    #                              dispatched lax.scan; the port: K replays of
    #                              one step captured in a CUDA graph)
    kl_weight: float = 1.0
    recon_reduction: str = "sum_points"  # sum_points | mean_points; VERIFY-vs-reference (§7)
    # train-time Gaussian jitter added to the input points (std, in the
    # normalized cloud frame). The dequantization-style regularizer for
    # likelihood training on exactly-surface-supported data: on shapes
    # with zero-thickness parts (v3 thin rods/slabs) the flow otherwise
    # drives density to infinity along the surface and val likelihood
    # diverges while train keeps improving (observed: v3 30k run, val
    # median neg-ELBO/pt -1.33 @10k -> -0.15 @30k). Train-only; eval and
    # sampling always see clean points. 0 disables (default).
    augment_noise: float = 0.0
    # optional linear anneal of the jitter: sigma walks augment_noise ->
    # augment_noise_final over the first augment_noise_anneal_steps steps,
    # then holds at the final value (smooth-early / sharpen-late schedule;
    # 0 anneal steps = constant sigma). sigma is a function of the
    # replicated step counter only, so every mesh-size bit-identity
    # guarantee of the constant-sigma path carries over unchanged.
    augment_noise_final: float = 0.0
    augment_noise_anneal_steps: int = 0
    # run the optimizer chain on one flattened parameter vector
    # (optax.flatten): the flagship param tree has 320 leaves and the
    # per-leaf clip/adam tiny-op soup costs real scheduling gaps on TPU —
    # measured 11.65 vs 11.99+ ms/step same-run (round 3). Identical math
    # (summation order aside); opt_state layout changes, so checkpoints
    # written with one setting resume with the same setting.
    flat_optimizer: bool = True
    # route the ELBO's point-flow term through the fused fwd(+logdet)
    # custom-VJP Pallas kernels (dpfx/ops/fused_train.py) instead of XLA's
    # per-layer HBM streaming; identical math (grad-parity tested), relu
    # conditioner + no actnorm only (falls back with a warning otherwise)
    fused_point_flow: bool = False
    # route q(z|X) through the fused PointNet kernel pair
    # (dpfx/ops/fused_encoder.py): per-point MLP + max-pool resident in
    # VMEM with a recompute backward — removes the [B, N, 512] activation
    # round-trip to HBM. Same flax param tree; relu + N <= ENC_MAX_POINTS
    # only (falls back with a warning otherwise). Point modality only.
    fused_encoder: bool = False
    # route log p(z) (and its gradients) through the fused latent-flow
    # kernel pair (dpfx/ops/fused_latent.py): the latent flow is ~1 us of
    # MXU work but 1.91 ms of the 11.65 ms flagship step as XLA tiny-op
    # soup (tools/prof_train.py, round 3). relu + no actnorm + dz > 16 only
    # (falls back with a warning otherwise).
    fused_latent_flow: bool = False
    # skip the whole update (params + optimizer moments) when the global
    # grad norm is non-finite: one overflowing batch cannot destroy the run
    # (the round-3 quality run diverged unrecoverably from a single spike
    # batch at paper scale). No reference analogue — TPU-production
    # robustness; a non-finite update is never correct.
    skip_nonfinite_updates: bool = True
    # abort the run (TrainDivergedError) after this many CONSECUTIVE log
    # windows in which every update was skipped as non-finite: a run that
    # diverged through finite updates would otherwise freeze forever while
    # burning its budget (observed in the round-3 AE attempt). 0 disables.
    abort_after_skipped_windows: int = 3
    # automatic divergence recovery (Trainer.fit_auto): on the abort above,
    # restore the latest checkpoint, multiply lr by recovery_lr_factor and
    # continue, at most max_recoveries times. Opt-in: recovery changes the
    # effective lr schedule. (Reference level is manual resume — SURVEY §5.)
    recover_on_divergence: bool = False
    max_recoveries: int = 2
    recovery_lr_factor: float = 0.5
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvalConfig:
    metrics: Tuple[str, ...] = ("cd",)   # subset of cd, emd
    batch_size: int = 32
    emd_iters: int = 10
    jsd_resolution: int = 28             # 28^3 voxel grid [pointflow-protocol]
    # JSD grid frame when clouds exceed the radius-0.5 grid sphere (the
    # shipped per_shape normalization reaches 1.0): "fit" = joint isotropic
    # shrink of both sets into the grid (resolution-preserving default);
    # "raw" = lineage edge-snap + warning. VERIFY-vs-reference (§9.7).
    jsd_frame: str = "fit"
    # pairwise-matrix kernel mode for the gen suite: "" = per-kernel default
    # (CD exact, EMD fast); "fast" = bf16 everywhere (CD matrix 3.3x faster
    # on-chip, metric-level drift bounded in tests); "exact" = parity-grade
    pairwise_precision: str = ""
    # sampling temperatures for the gen suite (round-5 v3 quality lever):
    # point base noise u = temperature * N(0, I3); latent base noise
    # eps = latent_temperature * N(0, I_dz). 1.0 == the unmodified sampler
    # (the reference protocol — keep 1.0 for any parity-grade table).
    temperature: float = 1.0
    latent_temperature: float = 1.0

    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ParallelConfig:
    """Device-mesh layout (SURVEY.md §2.2). DP over the batch axis is the one
    required strategy; XLA emits the gradient all-reduce over ICI from the
    sharding annotations."""

    data_axis: int = -1          # -1 -> all devices on the data axis
    axis_name: str = "data"
    # multi-process (multi-host) execution, e.g. one process per v5e host:
    # jax.distributed.initialize happens at CLI startup when coordinator is
    # set (or via JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID
    # env vars). See dpfx/parallel/distributed.py.
    coordinator: str = ""        # "host:port" of process 0
    num_processes: int = 0       # 0 -> from env / auto
    process_id: int = -1         # -1 -> from env / auto
    # device-resident stack placement on multi-device meshes:
    #   replicated — every device holds the full split (round-3 behavior;
    #                fine for one host, 8x HBM waste at v5e-8 scale)
    #   sharded    — cloud axis sharded over the mesh; batches are
    #                psum-gathered on device (bit-identical updates,
    #                ~B*N*3*4-byte all-reduce per step over ICI)
    resident_sharding: str = "replicated"
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    experiment: str = "ae"       # ae | gen | svr
    name: str = "dpfx"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    extra: Dict[str, Any] = field(default_factory=dict)


for _cls in (
    FlowConfig,
    EncoderConfig,
    ImageEncoderConfig,
    ModelConfig,
    DataConfig,
    TrainConfig,
    EvalConfig,
    ParallelConfig,
    Config,
):
    _TYPE_REGISTRY[_cls.__name__] = _cls


def config_from_dict(data: Dict[str, Any], strict: bool = False) -> Config:
    return _build(Config, data, strict, "config")


def load_config(path: str, strict: bool = False, overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML experiment config.

    ``overrides`` is a list of ``dotted.key=value`` strings (CLI convenience),
    applied after the file, values parsed as YAML scalars.
    """
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if overrides:
        for ov in overrides:
            key, _, raw = ov.partition("=")
            if not _:
                raise ValueError(f"override must be key=value, got {ov!r}")
            node = data
            parts = key.strip().split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = yaml.safe_load(raw)
    return config_from_dict(data, strict=strict)


def config_to_dict(cfg) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out
