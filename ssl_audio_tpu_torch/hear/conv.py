"""HEAR 2021 API for the conv encoders, AudioNTT2022 and the ResNets
resnet18, resnet18_ReGP_NRF, resnet50 and resnet50_ReGP_NRF (port of
ssl_audio_tpu/hear/conv.py): load_model, get_scene_embeddings and
get_timestamp_embeddings, torch tensors in and out, with the model held on
`device` ("cuda" unless the caller passes another).  The embedding size is
the encoder's: 3072 for AudioNTT2022, 512 / 2048 for resnet18 / resnet50,
4096 / 16384 for their ReGP-NRF forms.

On a CUDA device the log-mel frontend runs the CUDA log-mel kernel and,
with fused_conv=True, block 1 of the encoder runs the fused
Conv-BN-ReLU-Pool kernel on inputs whose H and W are even (the 0.95-s
timestamp windows; the 10-s scene clips have T = 1001 and take the plain
block, as in JAX).  The ResNets run cuDNN convolutions only: fused_conv and
pool_reorder are accepted and change nothing for them, as in JAX.

compute_dtype="bfloat16" runs the encoder in bf16, as the JAX wrapper
does (hear/conv.py:83-101): the parameters are cast once at load, the BN
running statistics stay fp32, each normalised log-mel batch is cast at the
encoder's input and the embeddings come back fp32 (models/precision.py);
with fused_conv=True block 1 takes the fused kernel's bf16 instantiation.
fetch_dtype="bfloat16" rounds the fp32 embeddings before the copy to the
host, with either compute type.

A reference `.pth` (or a training checkpoint of the port) loads as the
JAX importer reads one (utils/weights.py load_reference_weights_): the
tensors the encoder needs, shapes checked, the file's others ignored, a
missing one a KeyError; for the ResNets a ResNet-D file's projection too.
A directory written by the JAX package (Orbax: a whole train state, a
params-only save or the importer's tree) loads as the JAX wrapper reads
it (hear/conv.py:115-128): its encoder's parameters and running
statistics, through utils/orbax.py and utils/weights.py
load_encoder_from_jax_; it needs tensorstore, and where that is absent the
ImportError gives the converter's command.  As in JAX, there is no SE
option here: AudioNTT2022 serves without SE blocks.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ssl_audio_tpu_torch.hear import utils
from ssl_audio_tpu_torch.hear.pipeline import (
    BATCH_SIZE,
    TIMESTAMP_FRAME_DUR,
    TIMESTAMP_HOP_SIZE,
    _as_numpy,
    frame_audio_on_device,
    timestamp_pipeline,
)
from ssl_audio_tpu_torch.models import resnet
from ssl_audio_tpu_torch.models.audiontt import AudioNTT2022, init_weights_
from ssl_audio_tpu_torch.models.precision import cast_params_, compute_dtype as _dtype_of
from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram
from ssl_audio_tpu_torch.utils import resolve_device
from ssl_audio_tpu_torch.utils.orbax import is_orbax_dir, read_orbax_tree
from ssl_audio_tpu_torch.utils.weights import (
    encoder_trees_from_jax,
    load_encoder_from_jax_,
    load_reference_state_dict,
    load_reference_weights_,
)


class ConvModelWrapper:
    def __init__(self, cfg, model_type: str, model_file_path: str,
                 fast_mel: bool = False, fetch_dtype: str = "float32",
                 fused_conv: bool | None = None,
                 pool_reorder: bool | None = None,
                 compute_dtype: str = "float32", device=None):
        if model_type not in ("audiontt", *resnet.MODEL_TYPES):
            raise NotImplementedError(f"Model type {model_type} is not supported")
        self.dtype = _dtype_of(compute_dtype)
        if fetch_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"fetch_dtype must be float32 or bfloat16, got {fetch_dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sample_rate = cfg.sample_rate
        self.model_type = model_type
        # fast_mel: on the TPU a 3-pass bf16 DFT with a 1.5e-4 contract; the
        # port's frontend is exact fp32 either way (ops/mel.py)
        self.fast_mel = fast_mel
        self.fetch_dtype = fetch_dtype
        self.compute_dtype = compute_dtype
        # pool_reorder selects the JAX package's eval order of block 2 (pool
        # before BN, an XLA-level choice); both orders compute the same
        # embeddings to fp32 rounding, and the port runs the plain one
        self.pool_reorder = bool(pool_reorder)
        self.model = (AudioNTT2022(n_mels=cfg.n_mels, fused_conv=bool(fused_conv))
                      if model_type == "audiontt" else resnet.FACTORIES[model_type]())
        self.embed_dim = self.model.embed_dim
        self.scene_embedding_size = self.embed_dim
        self.timestamp_embedding_size = self.embed_dim
        self.mel = MelSpec.from_config(cfg)
        self._load_weights(model_file_path)
        cast_params_(self.model, self.dtype)
        self.model.to(self.device).eval()

    def _load_weights(self, model_file_path: str) -> None:
        if not model_file_path:
            # the JAX wrapper's model.init(key 0), drawn from a torch generator
            init = init_weights_ if self.model_type == "audiontt" else resnet.init_resnet_weights_
            init(self.model, torch.Generator().manual_seed(0))
            return
        if is_orbax_dir(model_file_path):
            load_encoder_from_jax_(self.model, *encoder_trees_from_jax(
                read_orbax_tree(model_file_path), model_file_path))
            return
        load_reference_weights_(self.model, load_reference_state_dict(model_file_path))

    @torch.no_grad()
    def forward(self, lms: torch.Tensor) -> torch.Tensor:
        """(B, 1, F, T) normalised log-mels -> (B, embed_dim) fp32 embeddings."""
        return self.model(lms.to(self.device).to(self.dtype)).float()

    @torch.no_grad()
    def to_feature(self, batch_audio) -> torch.Tensor:
        """(B, L) wav -> (B, 1, n_mels, T) log-mel on the model's device."""
        wav = torch.as_tensor(batch_audio, dtype=torch.float32).to(self.device)
        return log_mel_spectrogram(wav, self.mel, self.fast_mel)[:, None]

    def to(self, device):
        return self

    def eval(self):
        return self


def load_model(model_file_path: str = "", model_type: str = "audiontt",
               cfg_path: str = "hear/config.yaml", fast_mel: bool = False,
               fetch_dtype: str = "float32", fused_conv: bool | None = None,
               pool_reorder: bool | None = None, compute_dtype: str = "float32",
               device=None) -> ConvModelWrapper:
    """The JAX load_model's arguments, in its order, plus `device`: "cuda" by default, and with no card it raises unless
    device="cpu".  An empty model_file_path gives random weights from a
    generator seeded with 0."""
    cfg = utils.load_config(cfg_path)
    return ConvModelWrapper(cfg, model_type, model_file_path,
                            fast_mel=fast_mel, fetch_dtype=fetch_dtype,
                            fused_conv=fused_conv, pool_reorder=pool_reorder,
                            compute_dtype=compute_dtype, device=device)


def get_timestamp_embeddings(
    audio_list: List,
    model: ConvModelWrapper,
    frame_duration: float = TIMESTAMP_FRAME_DUR,
    hop_size: float = TIMESTAMP_HOP_SIZE,
    cfg_path: str = "hear/config.yaml",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_sounds, n_samples) audio -> (n_sounds, n_frames, embed_dim)
    embeddings and (n_sounds, n_frames) centred timestamps in ms."""
    audio = _as_numpy(audio_list)
    frame_size = int((frame_duration / 1000) * model.cfg.sample_rate)
    flat, timestamps, N = frame_audio_on_device(
        audio, frame_size, hop_size, model.cfg.sample_rate, model.device)
    n_sounds = audio.shape[0]
    emb = timestamp_pipeline(model.to_feature, model.forward, flat, N,
                             fetch_dtype=model.fetch_dtype)
    return emb.reshape(n_sounds, N // n_sounds, -1), timestamps


def get_scene_embeddings(
    audio_list: List,
    model: ConvModelWrapper,
    cfg_path: str = "hear/config.yaml",
) -> torch.Tensor:
    """One embedding per clip: log-mel -> scene-stats normalise -> encoder."""
    try:
        audio = _as_numpy(audio_list)
    except ValueError:
        # variable-length clip list: the reference's per-clip loop
        lms_list = [model.to_feature(_as_numpy(a)[None]) for a in audio_list]
        mean, std = utils.compute_scene_stats([l.cpu().numpy() for l in lms_list])
        return torch.cat([model.forward((l - mean) / std).cpu()
                          for l in lms_list]).float()
    # equal-length clips (the heareval case): one batched log-mel, the
    # mean of per-clip means and of per-clip unbiased stds, batched forwards
    lms = model.to_feature(audio)                              # (B, 1, F, T)
    mean = lms.mean(dim=(1, 2, 3)).mean()
    std = lms.std(dim=(1, 2, 3)).mean()
    embs = [model.forward((lms[i : i + BATCH_SIZE] - mean) / std).cpu()
            for i in range(0, lms.shape[0], BATCH_SIZE)]
    return torch.cat(embs).float()
