"""Configuration of the port (its own copy of ssl_audio_tpu/config.py: the
same Config fields, defaults and CLI flags, so invocations carry over).

A flag of a part that is not ported yet still parses; `unsupported_settings`
names every such setting a Config turns on, and the entry points raise
NotImplementedError on them before any work starts, so none is silently
ignored.  `--device` is the port's own flag: "cuda" by default, and with no
card an entry point raises unless the caller asks for "cpu".  `--config
FILE.yaml` (parse_config, JAX config_from_args) reads settings from a yaml
file under the command line's flags; it needs PyYAML, which the card's
machine lacks.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from dataclasses import dataclass, field
from typing import List, Optional

from ssl_audio_tpu_torch import parallel

MODELS = [
    "resnet50", "resnet50_ReGP_NRF",
    "resnet18", "resnet18_ReGP_NRF",
    "audiontt",
    "vit_base", "vit_small", "vit_tiny",
    "vitc_base", "vitc_small", "vitc_tiny",
]

DATASETS = [
    "fsd50k", "audioset", "librispeech", "fsd50k+librispeech",
    "audioset+librispeech", "nsynth", "audioset_wav", "cifar10",
    "synthetic",      # host-free random log-mels for smoke and bench runs
    "synthetic_wav",  # raw waveforms for the on-device-frontend mode
    "synthetic_multicue",
]

OPTIMIZERS = ["Adam", "AdamW", "SGD", "LARS"]

PORTED_MODELS = tuple(MODELS)
PORTED_DATASETS = tuple(DATASETS)


@dataclass
class Config:
    # model / data selection
    model_type: str = "audiontt"
    dataset: str = "fsd50k"
    epochs: int = 100
    lr_schedule: bool = False
    epoch_save_f: int = 5
    epoch_eval_f: int = 5
    no_eval: bool = False
    batch_size: int = 128

    # Barlow Twins objective
    lmbda: float = 0.005
    alpha: float = 1.0
    HSIC: bool = False

    # projector / predictor heads
    projector_out_dim: int = 256
    projector_n_hidden_layers: int = 1
    projector_hidden_dim: int = 8192
    predictor: bool = False
    stop_gradient: bool = False

    # multi-crop
    local_crops_number: int = 0
    local_crops_size: List[int] = field(default_factory=lambda: [16, 16])

    # audio frontend
    unit_sec: float = 0.95
    crop_frames: int = 96
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 160
    n_mels: int = 64
    f_min: int = 60
    f_max: int = 7800

    num_workers: int = 20

    # augmentations
    mixup_ratio: float = 0.2
    virtual_crop_scale: List[float] = field(default_factory=lambda: [1.0, 1.5])
    mixup: bool = True
    RRC: bool = True
    RLF: bool = True
    Gnoise: bool = False
    pre_norm: bool = False
    post_norm: bool = False

    load_lms: bool = True
    distributed: bool = False
    use_fp16: bool = False          # the encoder in bf16, fp32 masters (models/precision.py)
    use_fp16_eval: bool = False
    name: str = ""
    squeeze_excitation: bool = False

    # ViT masking
    mask: bool = False
    mask_ratio: float = 0.0
    random_mask_ratio: bool = False
    mask_ratio_schedule: bool = False
    mask_beta: float = 0.3
    remat: bool = False             # gradient checkpointing of the ViT encoder's blocks
    # N train steps per device dispatch (CUDA graphs on the card; 1 = step by step)
    steps_per_dispatch: int = 1
    # AudioNTT block 1 through the fused Conv-BN-ReLU-Pool kernels
    # (ops/fused_conv.py).  None = auto: on.  The block computes the same
    # function on the CPU (plain versions) and on the card (CUDA kernels).
    fused_conv: Optional[bool] = None
    # Pool-reordered training composition of AudioNTT block 2
    # (models/audiontt.py).  None = auto: on.
    pool_reorder: Optional[bool] = None
    # ViT attention through the kernels of ops/fused_attention.py (bf16 dot
    # operands, as the TPU kernel).  None = off: the fp32 einsum path, the
    # JAX package's default.  --fused_attention turns it on.
    fused_attention: Optional[bool] = None
    # an XLA layout option of the JAX package, with no counterpart here
    layout_barrier: Optional[bool] = None
    # accepted for the JAX flag surface: the port's log-mel is exact fp32
    # either way (ops/mel.py)
    fast_mel: bool = False
    token_drop: bool = True
    use_learned_pos_embd: bool = False
    use_cls: bool = True
    use_mean_pool: bool = False
    patch_size: List[int] = field(default_factory=lambda: [16, 16])
    masked_recon: bool = False

    save_base_dir: str = ""
    resume_path: Optional[str] = None

    # optimizer (filled by setup_model_defaults)
    optimizer: Optional[str] = None
    lr: Optional[float] = None
    lr_weights: Optional[float] = None
    lr_biases: Optional[float] = None
    wd: Optional[float] = None

    # BYOL variant
    moving_average_decay: float = 0.99

    # recipe knobs of the legacy DINO / BYOL-A trainers (main_pretrain
    # --method dino|byola, train/legacy_steps.py)
    base_lr: Optional[float] = None
    final_lr: float = 1.0e-6
    final_wd: Optional[float] = None
    warmup_epochs: int = 6
    momentum_teacher: float = 0.996
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.4
    warmup_teacher_temp_epochs: int = 18
    dino_out_dim: int = 4096
    proj_size: int = 256
    proj_dim: int = 4096

    # parallelism: data_axis_size 0 or the world size (parallel/); tensor
    # parallelism and FSDP are not ported yet
    data_axis_size: int = 0
    model_parallel: int = 1
    fsdp: bool = False
    # mixup memory-bank size: rows of the on-device ring buffer
    mixup_n_memory: int = 2048
    # seed for all RNG
    seed: int = 0
    # steps per epoch when the dataset is synthetic
    synthetic_steps_per_epoch: int = 100
    synthetic_len: int = 12800
    profile_dir: str = ""
    audioset_balanced_only: bool = False
    audioset_200k_only: bool = False
    # where the entry points run: None = "cuda" (raises without a card)
    device: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.local_crops_size, tuple):
            self.local_crops_size = list(self.local_crops_size)
        if isinstance(self.patch_size, tuple):
            self.patch_size = list(self.patch_size)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def setup_model_defaults(cfg: Config, method: Optional[str] = None) -> Config:
    """The reference's model-conditional optimizer defaults: ViT -> AdamW,
    conv -> LARS, learning rates scaled by batch_size / 128.  Explicit
    values win.

    method "dino" or "byola" first puts in the legacy trainer's own recipe
    (AdamW with cosine lr and weight-decay schedules, base_lr 5e-4, wd 0.04
    -> final_wd 0.4; plain Adam at base_lr 3e-4): explicit values win, and
    the recipe wins over the model-type fill below."""
    if method == "dino":
        cfg = cfg.replace(
            optimizer="AdamW",
            base_lr=cfg.base_lr if cfg.base_lr is not None else 5.0e-4,
            wd=cfg.wd if cfg.wd is not None else 0.04,
            final_wd=cfg.final_wd if cfg.final_wd is not None else 0.4)
    elif method == "byola":
        cfg = cfg.replace(
            optimizer="Adam",
            base_lr=cfg.base_lr if cfg.base_lr is not None else 3.0e-4,
            wd=cfg.wd if cfg.wd is not None else 0.0)
    if "vit" in cfg.model_type:
        opt = cfg.optimizer or "AdamW"
        lr = cfg.lr if cfg.lr is not None else 1e-4 * cfg.batch_size / 128
        wd = cfg.wd if cfg.wd is not None else 0.06
        return cfg.replace(optimizer=opt, lr=lr, wd=wd)
    opt = cfg.optimizer or "LARS"
    lr_w = cfg.lr_weights if cfg.lr_weights is not None else 0.4 * cfg.batch_size / 128
    lr_b = cfg.lr_biases if cfg.lr_biases is not None else 0.0048 * cfg.batch_size / 128
    wd = cfg.wd if cfg.wd is not None else 1e-5
    return cfg.replace(optimizer=opt, lr_weights=lr_w, lr_biases=lr_b, wd=wd)


def default_config(method: Optional[str] = None, **kw) -> Config:
    return setup_model_defaults(Config(**kw), method=method)


def unsupported_settings(cfg: Config) -> List[str]:
    """Every setting of cfg that belongs to a part not ported yet, as
    messages; empty when the training slice can run cfg."""
    bad = []
    if cfg.model_type not in PORTED_MODELS:
        bad.append(f"--model_type {cfg.model_type} (ported: {', '.join(PORTED_MODELS)})")
    if cfg.dataset not in PORTED_DATASETS:
        bad.append(f"--dataset {cfg.dataset} (ported: {', '.join(PORTED_DATASETS)})")
    world = parallel.launched_world_size(cfg)
    if cfg.data_axis_size not in (0, world):
        bad.append(f"--data_axis_size {cfg.data_axis_size} (a data axis of other than the "
                   f"world size, {world}: the port runs one process per GPU, so launch N "
                   f"with torchrun --nproc_per_node N ... --distributed; a mesh of devices "
                   f"inside one process is not ported yet, ROADMAP.md queue A, item 1)")
    for flag, on, what in (
            ("--model_parallel > 1", cfg.model_parallel != 1,
             "tensor parallelism not ported yet, ROADMAP.md queue A, item 1"),
            ("--fsdp", cfg.fsdp, "sharded parameters not ported yet, ROADMAP.md queue A, item 1"),
            ("--layout_barrier", bool(cfg.layout_barrier),
             "an XLA layout option, not ported yet: nothing in PyTorch to port it to")):
        if on:
            bad.append(f"{flag} ({what})")
    return bad


def require_supported(cfg: Config) -> None:
    """NotImplementedError naming every unported setting of cfg; ValueError
    for a combination the JAX package cannot run either (cifar10 with an
    encoder other than the ViT family)."""
    if cfg.dataset == "cifar10" and "vit" not in cfg.model_type:
        raise ValueError(f"--dataset cifar10 trains the ViT family only (vit_*, vitc_*), "
                         f"not {cfg.model_type}")
    bad = unsupported_settings(cfg)
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(bad))


def config_fingerprint(cfg: Config):
    """(resolved-config dict, short sha256): stamped into the learning
    proof's record, so a record made under another configuration shows."""
    d = dataclasses.asdict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str)
    return d, hashlib.sha256(blob.encode()).hexdigest()[:16]


def _add_bool_pair(parser, name, default, negative=None):
    parser.add_argument(f"--{name}", action="store_true", default=default)
    if negative:
        parser.add_argument(f"--{negative}", action="store_false", dest=name)


def build_argparser() -> argparse.ArgumentParser:
    """The JAX package's flag surface (less its XLA compilation-cache flags;
    parse_config adds `--config`), plus --device."""
    p = argparse.ArgumentParser(description="ssl_audio_tpu_torch", add_help=True)
    p.add_argument("--model_type", default="audiontt", type=str, choices=MODELS)
    p.add_argument("--dataset", default="fsd50k", type=str, choices=DATASETS)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr_schedule", action="store_true", default=False)
    p.add_argument("--epoch_save_f", default=5, type=int)
    p.add_argument("--epoch_eval_f", default=5, type=int)
    p.add_argument("--no_eval", action="store_true", default=False)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lmbda", type=float, default=0.005)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--projector_out_dim", default=256, type=int)
    p.add_argument("--projector_n_hidden_layers", default=1, type=int)
    p.add_argument("--projector_hidden_dim", default=8192, type=int)
    p.add_argument("--local_crops_number", type=int, default=0)
    p.add_argument("--local_crops_size", nargs="+", type=int, default=[16, 16])
    p.add_argument("--unit_sec", type=float, default=0.95)
    p.add_argument("--crop_frames", type=int, default=96)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_fft", type=int, default=1024)
    p.add_argument("--win_length", type=int, default=1024)
    p.add_argument("--hop_length", type=int, default=160)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--f_min", type=int, default=60)
    p.add_argument("--f_max", type=int, default=7800)
    p.add_argument("--num_workers", type=int, default=20)
    p.add_argument("--mixup_ratio", type=float, default=0.2)
    p.add_argument("--virtual_crop_scale", nargs="+", type=float, default=[1, 1.5])
    p.add_argument("--HSIC", action="store_true", default=False)
    _add_bool_pair(p, "mixup", True, "no_mixup")
    _add_bool_pair(p, "RRC", True, "no_RRC")
    _add_bool_pair(p, "RLF", True, "no_RLF")
    p.add_argument("--Gnoise", action="store_true", default=False)
    p.add_argument("--pre_norm", action="store_true", default=False)
    p.add_argument("--post_norm", action="store_true", default=False)
    p.add_argument("--load_lms", action="store_true", default=True)
    p.add_argument("--load_wav", action="store_false", dest="load_lms")
    p.add_argument("--distributed", action="store_true", default=False)
    p.add_argument("--use_fp16", action="store_true", default=False)
    p.add_argument("--use_fp16_eval", action="store_true", default=False)
    p.add_argument("--name", type=str, default="")
    p.add_argument("--squeeze_excitation", action="store_true", default=False)
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--mask_ratio", type=float, default=0.0)
    p.add_argument("--random_mask_ratio", action="store_true", default=False)
    p.add_argument("--mask_ratio_schedule", action="store_true", default=False)
    p.add_argument("--mask_beta", type=float, default=0.3)
    p.add_argument("--no_token_drop", dest="token_drop", action="store_false",
                   default=True)
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--fused_conv", action="store_true", default=None)
    p.add_argument("--no_fused_conv", dest="fused_conv", action="store_false")
    p.add_argument("--pool_reorder", action="store_true", default=None)
    p.add_argument("--no_pool_reorder", dest="pool_reorder", action="store_false")
    p.add_argument("--fused_attention", action="store_true", default=None)
    p.add_argument("--no_fused_attention", dest="fused_attention", action="store_false")
    p.add_argument("--layout_barrier", action="store_true", default=None)
    p.add_argument("--no_layout_barrier", dest="layout_barrier", action="store_false")
    p.add_argument("--fast_mel", action="store_true", default=False)
    p.add_argument("--use_learned_pos_embd", action="store_true", default=False)
    p.add_argument("--use_cls", action="store_true", default=True)
    p.add_argument("--use_mean_pool", action="store_true", default=False)
    p.add_argument("--patch_size", nargs="+", type=int, default=[16, 16])
    p.add_argument("--masked_recon", action="store_true", default=False)
    p.add_argument("--stop_gradient", action="store_true", default=False)
    p.add_argument("--predictor", action="store_true", default=False)
    p.add_argument("--save_base_dir", type=str, default="")
    p.add_argument("--resume_path", type=str, default=None)
    p.add_argument("--optimizer", type=str, default=None, choices=OPTIMIZERS)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_weights", type=float, default=None)
    p.add_argument("--lr_biases", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--moving_average_decay", type=float, default=0.99)
    p.add_argument("--base_lr", type=float, default=None)
    p.add_argument("--final_lr", type=float, default=1.0e-6)
    p.add_argument("--final_wd", type=float, default=None)
    p.add_argument("--warmup_epochs", type=int, default=6)
    p.add_argument("--momentum_teacher", type=float, default=0.996)
    p.add_argument("--warmup_teacher_temp", type=float, default=0.04)
    p.add_argument("--teacher_temp", type=float, default=0.4)
    p.add_argument("--warmup_teacher_temp_epochs", type=int, default=18)
    p.add_argument("--dino_out_dim", type=int, default=4096)
    p.add_argument("--proj_size", type=int, default=256)
    p.add_argument("--proj_dim", type=int, default=4096)
    p.add_argument("--data_axis_size", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--fsdp", action="store_true", default=False)
    p.add_argument("--mixup_n_memory", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_steps_per_epoch", type=int, default=100)
    p.add_argument("--synthetic_len", type=int, default=12800)
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--audioset_balanced_only", action="store_true", default=False)
    p.add_argument("--audioset_200k_only", action="store_true", default=False)
    p.add_argument("--device", type=str, default=None,
                   help='"cuda" by default; "cpu" runs the plain PyTorch path')
    return p


# --config: yaml keys of the reference's legacy recipes (old/configs/*.yaml)
# -> Config fields, as JAX config_from_args maps them (config.py:449-455).
# batch_size_per_gpu goes to batch_size, the GLOBAL batch in both packages:
# a quirk copied from JAX
YAML_ALIASES = (("lambd", "lmbda"), ("base_lr", "lr"), ("batch_size_per_gpu", "batch_size"),
                ("save_epoch_it", "epoch_save_f"), ("weight_decay", "wd"),
                ("final_weight_decay", "final_wd"), ("ema_decay", "moving_average_decay"),
                ("out_dim", "dino_out_dim"))


def _yaml_settings(path: str, parser: argparse.ArgumentParser, argv: List[str],
                   known: set) -> dict:
    """The Config fields a yaml file sets that the command line does not:
    nested sections flattened at any depth, YAML_ALIASES applied (an alias
    that is itself a field, base_lr, keeps its own value too), None values
    skipped; a flag given in argv wins, found through the parser's option
    table, so `--no_pool_reorder` beats a yaml `pool_reorder: true`."""
    try:
        import yaml
    except ImportError as e:
        raise ModuleNotFoundError(
            f"--config {path}: reading a yaml config needs PyYAML (the `yaml` package), "
            "which is not installed here; give the settings as flags instead",
            name="yaml") from e
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    flat = {}

    def flatten(node):
        for k, v in node.items():
            if isinstance(v, dict):
                flatten(v)
            else:
                flat[k] = v

    flatten(raw)
    for src, dst in YAML_ALIASES:
        if src in flat and dst not in flat:
            flat[dst] = flat[src] if src in known else flat.pop(src)
    opt_to_dest = {s: a.dest for s, a in parser._option_string_actions.items()}
    explicit = {opt_to_dest.get(a.split("=")[0], a.split("=")[0].lstrip("-"))
                for a in argv if a.startswith("--")}
    return {k: v for k, v in flat.items() if k in known and k not in explicit and v is not None}


def parse_config(parser: argparse.ArgumentParser, argv=None) -> tuple[argparse.Namespace, dict]:
    """Parse argv (sys.argv[1:] by default) with `parser` and a `--config`
    flag -> (the namespace, the Config fields: the flags' values, under
    which the yaml file of --config is laid)."""
    parser.add_argument("--config", type=str, default=None,
                        help="yaml config file; flags on the command line override its values")
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    fields = {k: v for k, v in vars(args).items() if k in known}
    if args.config:
        fields.update(_yaml_settings(args.config, parser, argv, known))
    return args, fields


def config_from_args(argv=None) -> Config:
    """CLI (and --config's yaml) -> Config with the model-conditional
    defaults filled in."""
    _, fields = parse_config(build_argparser(), argv)
    return setup_model_defaults(Config(**fields))
