"""Weights for the port's AudioNTT2022 and ViT (port of the AudioNTT and ViT
parts of ssl_audio_tpu/utils/torch_export.py and utils/torch_import.py) and
for the whole train state (encoder, projector, predictor, LARS momentum).

The port's modules use the reference's torch parameter names, so a
reference-layout `.pth` loads as it is, and a JAX variable tree converts
with the same rules torch_export uses: Conv HWIO -> OIHW, Dense (in, out)
-> (out, in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var (plus a zero num_batches_tracked, as every torch BatchNorm
state dict has).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# nested prefixes the reference's checkpoints carry (its linear.py and HEAR
# modules strip them the same way)
_PREFIXES = ("backbone.encoder.encoder.", "backbone.encoder.",
             "encoder.encoder.", "encoder.")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params, stats) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(w) -> torch.Tensor:
    """flax HWIO -> torch OIHW."""
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def audiontt_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """{"params": {"encoder": ...}, "batch_stats": {"encoder": ...}} of the
    JAX AudioNTT2022, as numpy arrays -> the port's state dict."""
    p = variables["params"]["encoder"]
    s = variables["batch_stats"]["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    for layer in range(2):
        base = 4 * layer
        sd[f"features.{base}.weight"] = _conv(p[f"Conv_{layer}"]["kernel"])
        sd[f"features.{base}.bias"] = _t(p[f"Conv_{layer}"]["bias"])
        _bn(sd, f"features.{base + 1}", p[f"BatchNorm_{layer}"], s[f"BatchNorm_{layer}"])
    for i, name in ((0, "Dense_0"), (3, "Dense_1")):
        sd[f"fc.{i}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
        sd[f"fc.{i}.bias"] = _t(p[name]["bias"])
    return sd


def vit_state_dict_from_jax(params, batch_stats, spec) -> Dict[str, torch.Tensor]:
    """The JAX MaskedAutoencoderViT's params and batch_stats (numpy arrays)
    -> the port's state dict, under the names of export_vit_state_dict:
    the ConvStem's BatchNorm running statistics and the MAE decoder
    included.  spec: the port's ViTSpec of the model.  The fixed position
    tables are the JAX model's constants (the decoder's is the 1-D table
    unless spec.use_2d_dec_pos_embd), not the exporter's."""
    from ssl_audio_tpu_torch.ops.pos_embed import (
        get_2d_sincos_pos_embed, get_sinusoid_encoding_table)

    grid = (spec.img_size[0] // spec.patch_size[0], spec.img_size[1] // spec.patch_size[1])
    sd: Dict[str, torch.Tensor] = {"cls_token": _t(params["cls_token"])}
    sd["pos_embed"] = (_t(params["pos_embed"]) if "pos_embed" in params else
                       _t(get_2d_sincos_pos_embed(spec.embed_dim, grid)[None]))
    pe = params["patch_embed"]
    if "conv0" in pe:                                   # ConvStem: [Conv, BN, ReLU] triples
        stats = (batch_stats or {}).get("patch_embed", {})
        n_stem = len([k for k in pe if k.startswith("conv")])
        for i in range(n_stem):
            sd[f"patch_embed.proj.{3 * i}.weight"] = _conv(pe[f"conv{i}"]["kernel"])
            _bn(sd, f"patch_embed.proj.{3 * i + 1}", pe[f"bn{i}"], stats[f"bn{i}"])
        sd[f"patch_embed.proj.{3 * n_stem}.weight"] = _conv(pe["proj"]["kernel"])
        sd[f"patch_embed.proj.{3 * n_stem}.bias"] = _t(pe["proj"]["bias"])
    else:
        sd["patch_embed.proj.weight"] = _conv(pe["proj"]["kernel"])
        sd["patch_embed.proj.bias"] = _t(pe["proj"]["bias"])

    def dense(prefix: str, p) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(p["bias"])

    def block(jax_name: str, prefix: str) -> None:
        b = params[jax_name]
        for norm in ("norm1", "norm2"):
            sd[f"{prefix}.{norm}.weight"] = _t(b[norm]["scale"])
            sd[f"{prefix}.{norm}.bias"] = _t(b[norm]["bias"])
        sd[f"{prefix}.attn.qkv.weight"] = _t(np.asarray(b["attn"]["qkv_kernel"]).T)
        sd[f"{prefix}.attn.q_bias"] = _t(b["attn"]["q_bias"])
        sd[f"{prefix}.attn.v_bias"] = _t(b["attn"]["v_bias"])
        dense(f"{prefix}.attn.proj", b["attn"]["proj"])
        dense(f"{prefix}.mlp.fc1", b["mlp"]["fc1"])
        dense(f"{prefix}.mlp.fc2", b["mlp"]["fc2"])

    for i in range(len([k for k in params if k.startswith("block")])):
        block(f"block{i}", f"blocks.{i}")
    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    if "decoder_embed" in params:
        dense("decoder_embed", params["decoder_embed"])
        sd["mask_token"] = _t(params["mask_token"])
        dim = spec.decoder_embed_dim
        sd["decoder_pos_embed"] = _t((
            get_2d_sincos_pos_embed(dim, grid) if spec.use_2d_dec_pos_embd
            else get_sinusoid_encoding_table(grid[0] * grid[1], dim))[None])
        for i in range(len([k for k in params if k.startswith("decoder_block")])):
            block(f"decoder_block{i}", f"decoder_blocks.{i}")
        sd["decoder_norm.weight"] = _t(params["decoder_norm"]["scale"])
        sd["decoder_norm.bias"] = _t(params["decoder_norm"]["bias"])
        dense("decoder_pred", params["decoder_pred"])
    return sd


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout `.pth` (optionally under "model" and a nested
    encoder prefix) -> a state dict for the port's module.  Loads tensors
    only (weights_only=True): a checkpoint file is outside input."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    for prefix in _PREFIXES:
        clean = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if clean:
            sd = clean
            break
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _mlp_state_dict_from_jax(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax head ({Dense_i, BatchNorm_i} + batch_stats) -> the port's
    Sequential of [Linear, BatchNorm1d, ReLU] * n + Linear under `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    n_dense = sum(1 for k in params if k.startswith("Dense_"))
    for i in range(n_dense):
        sd[f"{prefix}.{3 * i}.weight"] = _t(np.asarray(params[f"Dense_{i}"]["kernel"]).T)
        if i < n_dense - 1:
            _bn(sd, f"{prefix}.{3 * i + 1}", params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])
    return sd


def train_state_dicts_from_jax(params, batch_stats,
                               vit_spec=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX train state's {"encoder", "head", "predictor"} parameter and
    batch-statistics trees (numpy arrays) -> {"encoder", "head", "predictor"}
    state dicts for the port's modules (train/state.py), so that a step can
    start from the same state in both packages.  vit_spec: the port
    encoder's ViTSpec when it is a ViT (None: AudioNTT2022).  An empty
    predictor tree (cfg.predictor off) gives an empty state dict."""
    if vit_spec is not None:
        out = {"encoder": vit_state_dict_from_jax(params["encoder"],
                                                  batch_stats.get("encoder"), vit_spec)}
    else:
        out = {"encoder": audiontt_state_dict_from_jax(
            {"params": params["encoder"], "batch_stats": batch_stats["encoder"]})}
    out["head"] = _mlp_state_dict_from_jax(params["head"], batch_stats["head"], "projector")
    out["predictor"] = _mlp_state_dict_from_jax(
        params.get("predictor") or {}, batch_stats.get("predictor") or {}, "predictor")
    return out


def lars_state_from_jax(mu) -> Dict[str, Dict[str, torch.Tensor]]:
    """The LARS momentum tree of the JAX optimizer state (shaped like the
    parameters) -> per module, momentum tensors under the port's parameter
    names (running statistics are not parameters and are left out)."""
    zeros = {"encoder": _zero_stats_like(mu["encoder"]), "head": _zero_stats_like(mu["head"]),
             "predictor": _zero_stats_like(mu.get("predictor") or {})}
    sds = train_state_dicts_from_jax(mu, zeros)
    return {name: {k: v for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
            for name, sd in sds.items()}


def _zero_stats_like(params):
    """A batch-statistics tree for a parameter-shaped tree: {mean, var} zeros
    beside every BatchNorm's {scale, bias}, at any nesting depth."""
    if not isinstance(params, dict):
        return {}
    if set(params) == {"scale", "bias"}:
        z = np.zeros_like(np.asarray(params["scale"]))
        return {"mean": z, "var": z}
    return {k: _zero_stats_like(v) for k, v in params.items() if isinstance(v, dict)}
