"""HEAR 2021 API for the ViT family (port of ssl_audio_tpu/hear/vit.py;
reference hear/sample/vit.py): load_model, get_scene_embeddings and
get_timestamp_embeddings, torch tensors in and out, with the model held on
`device` ("cuda" unless the caller passes another).

A clip's log-mel is cut into img_size[1]-frame units (96 frames, 0.95 s)
and each unit's CLS embedding is taken after the final LayerNorm; an
embedding is the mean over the units.  A 0.95-s timestamp window is exactly
one unit, and the reference still appends a full unit of zeros, whose
embedding (one forward at batch 1 per chunk) enters every window's mean
(eval/encode.py).  Scene requests normalise by one mean and one unbiased
std over the whole batch of log-mels; timestamp requests by the 1/N
statistics of hear/pipeline.py.  As in the JAX wrapper, the attention is
the fp32 einsum path and the model stays in eval mode (its ConvStem's
BatchNorms on their running statistics).

On a CUDA device the log-mel frontend runs the CUDA log-mel kernel.  The
metadata keep the JAX wrapper's values: timestamp_embedding_size is
embed_dim * grid_size()[0] while the timestamp embeddings are embed_dim
wide.

compute_dtype="bfloat16" runs the encoder in bf16, as the JAX wrapper
does (hear/vit.py:65-73, :117-120): the parameters are cast once at load,
the ConvStem's running statistics and the fixed position table stay fp32,
each unit batch is cast at the encoder's input and the embeddings come back
fp32 (models/precision.py); the attention stays the einsum path, in bf16.

A reference-layout `.pth` loads as the JAX importer reads it
(utils/weights.py load_vit_reference_weights_): the model's own tensors by
name and shape, its fixed sin-cos table kept whatever the file holds, the
file's other keys (a classifier head, an MAE decoder) ignored, and a
missing tensor a KeyError.

A directory written by the JAX package (Orbax: a whole train state, a
params-only save or the importer's tree) loads as the JAX wrapper reads it
(hear/vit.py:95-110): the encoder's parameters (and a ConvStem's running
statistics) under the same rule as a `.pth`, through utils/orbax.py and
utils/weights.py load_encoder_from_jax_; it needs tensorstore, and where
that is absent the ImportError gives the converter's command.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ssl_audio_tpu_torch.eval.encode import encode_lms_units
from ssl_audio_tpu_torch.hear import utils
from ssl_audio_tpu_torch.hear.pipeline import (
    TIMESTAMP_FRAME_DUR,
    TIMESTAMP_HOP_SIZE,
    _as_numpy,
    fetch,
    frame_audio_on_device,
    timestamp_pipeline,
)
from ssl_audio_tpu_torch.models.precision import cast_params_, compute_dtype as _dtype_of
from ssl_audio_tpu_torch.models.vit import get_mae_vit, init_vit_weights_
from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram
from ssl_audio_tpu_torch.utils import resolve_device
from ssl_audio_tpu_torch.utils.orbax import is_orbax_dir, read_orbax_tree
from ssl_audio_tpu_torch.utils.weights import (
    encoder_trees_from_jax,
    load_encoder_from_jax_,
    load_reference_state_dict,
    load_vit_reference_weights_,
)


class ViTModelWrapper:
    def __init__(self, cfg, model_type: str, model_file_path: str, patch_size,
                 fetch_dtype: str = "float32", fast_mel: bool = False,
                 compute_dtype: str = "float32", device=None):
        self.dtype = _dtype_of(compute_dtype)
        if fetch_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"fetch_dtype must be float32 or bfloat16, got {fetch_dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # fast_mel: on the TPU a 3-pass bf16 DFT; the port's frontend is exact
        # fp32 either way (ops/mel.py)
        self.fast_mel = fast_mel
        self.compute_dtype = compute_dtype
        self.use_cls = True if cfg.get("use_cls") is None else cfg.use_cls
        self.sample_rate = cfg.sample_rate
        self.fetch_dtype = fetch_dtype
        self.model = get_mae_vit(model_type.split("_")[-1], patch_size, "vitc" in model_type)
        self.embed_dim = self.model.embed_dim
        self.scene_embedding_size = self.embed_dim
        self.timestamp_embedding_size = self.embed_dim * self.model.grid_size()[0]
        self.mel = MelSpec.from_config(cfg)
        self._load_weights(model_file_path)
        cast_params_(self.model, self.dtype)
        self.model.to(self.device).eval()

    def _load_weights(self, model_file_path: str) -> None:
        if not model_file_path:
            # the JAX wrapper's model.init(key 0), drawn from a torch generator
            init_vit_weights_(self.model, torch.Generator().manual_seed(0))
            return
        if is_orbax_dir(model_file_path):
            load_encoder_from_jax_(self.model, *encoder_trees_from_jax(
                read_orbax_tree(model_file_path), model_file_path))
            return
        load_vit_reference_weights_(self.model, load_reference_state_dict(model_file_path))

    @torch.no_grad()
    def unit_apply(self, xu: torch.Tensor) -> torch.Tensor:
        """(B', 1, F, unit) -> (B', D) fp32 CLS embeddings."""
        return self.model(xu.to(self.device).to(self.dtype)).float()

    def encode_lms(self, lms: torch.Tensor) -> torch.Tensor:
        """(B, 1, F, T) normalised log-mels -> (B, U, D) per-unit CLS
        embeddings (reference vit.py:109-126)."""
        return encode_lms_units(lambda xu, _return_all: self.unit_apply(xu), lms,
                                self.model.spec.img_size[1])

    @torch.no_grad()
    def to_feature(self, batch_audio) -> torch.Tensor:
        """(B, L) wav -> (B, 1, n_mels, T) log-mel on the model's device."""
        wav = torch.as_tensor(batch_audio, dtype=torch.float32).to(self.device)
        return log_mel_spectrogram(wav, self.mel, self.fast_mel)[:, None]

    def encode(self, batch_audio) -> torch.Tensor:
        """(B, L) wav -> (B, U, D): log-mel, normalised by the batch's mean
        and unbiased std (the reference's _normalize_batch), then units."""
        x = self.to_feature(batch_audio)
        return self.encode_lms((x - x.mean()) / x.std())

    # heareval calls these; the model stays where load_model put it, in eval mode
    def to(self, device):
        return self

    def eval(self):
        return self


def load_model(model_file_path: str = "", model_type: str = "vitc_base",
               patch_size: str = "16x8", cfg_path: str = "hear/config.yaml",
               fetch_dtype: str = "float32", fast_mel: bool = False,
               compute_dtype: str = "float32", device=None) -> ViTModelWrapper:
    """The JAX load_model's arguments plus `device`: "cuda" by default, and
    with no card it raises unless device="cpu".  An empty model_file_path
    gives random weights from a generator seeded with 0; a reference-layout
    .pth loads strictly (less any MAE decoder weights), ConvStem running
    statistics included."""
    cfg = utils.load_config(cfg_path)
    ps = [int(patch_size.split("x")[0]), int(patch_size.split("x")[-1])]
    return ViTModelWrapper(cfg, model_type, model_file_path, ps, fetch_dtype=fetch_dtype,
                           fast_mel=fast_mel, compute_dtype=compute_dtype, device=device)


def get_timestamp_embeddings(
    audio_list: List,
    model: ViTModelWrapper,
    frame_duration: float = TIMESTAMP_FRAME_DUR,
    hop_size: float = TIMESTAMP_HOP_SIZE,
    cfg_path: str = "hear/config.yaml",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_sounds, n_samples) audio -> (n_sounds, n_frames, embed_dim)
    embeddings, each the mean of its window's unit CLS embeddings, and
    (n_sounds, n_frames) centred timestamps in ms (reference vit.py:157-226)."""
    audio = _as_numpy(audio_list)
    frame_size = int((frame_duration / 1000) * model.cfg.sample_rate)
    flat, timestamps, N = frame_audio_on_device(
        audio, frame_size, hop_size, model.cfg.sample_rate, model.device)
    n_sounds = audio.shape[0]
    emb = timestamp_pipeline(model.to_feature, lambda m: model.encode_lms(m).mean(dim=1),
                             flat, N, fetch_dtype=model.fetch_dtype)
    return emb.reshape(n_sounds, N // n_sounds, -1), timestamps


def get_scene_embeddings(audio_list: List, model: ViTModelWrapper) -> torch.Tensor:
    """One embedding per clip: log-mel -> batch-statistics normalise ->
    per-unit CLS -> mean over units (reference vit.py:229-247)."""
    return fetch(model.encode(_as_numpy(audio_list)).mean(dim=1)).float()
