"""Weights for the port's encoders: AudioNTT2022 (with or without SE
blocks), the ResNets and the ViT family (port of ssl_audio_tpu/utils/
torch_export.py and utils/torch_import.py), and for the whole train state
(encoder, projector, predictor, LARS momentum) and the legacy DINO /
BYOL-A states (legacy_state_dicts_from_jax).

The port's modules use the reference's torch parameter names, so a
reference-layout `.pth` loads as it is, and a JAX variable tree converts
with the same rules torch_export uses: Conv HWIO -> OIHW, Dense (in, out)
-> (out, in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var (plus a zero num_batches_tracked, as every torch BatchNorm
state dict has).

A reference `.pth` loads into a port module as the JAX importer reads one
(load_reference_weights_): every tensor the module needs, with its shape
checked, and nothing else; a missing one raises KeyError, a file's other
tensors are ignored.  A ViT keeps its own fixed sin-cos tables and reads
a learned position table resized to its grid (load_vit_reference_weights_).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

# nested prefixes the reference's checkpoints carry (its linear.py and HEAR
# modules strip them the same way)
_PREFIXES = ("backbone.encoder.encoder.", "backbone.encoder.",
             "encoder.encoder.", "encoder.")


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):              # a bfloat16 leaf of utils/orbax.py
        return x.detach().float().clone()
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


def _linear(w) -> torch.Tensor:
    """flax Dense (in, out) -> torch Linear (out, in)."""
    return _t(np.asarray(w).T)


def audiontt_state_dict_from_jax(variables,
                                 squeeze_excitation: bool = False) -> Dict[str, torch.Tensor]:
    """{"params": {"encoder": ...}, "batch_stats": {"encoder": ...}} of the
    JAX AudioNTT2022, as numpy arrays -> the port's state dict.  With SE
    blocks a block is 5 modules, its SE at features.{4,9}."""
    p = variables["params"]["encoder"]
    s = variables["batch_stats"]["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    block_len = 5 if squeeze_excitation else 4
    for layer in range(2):
        base = block_len * layer
        sd[f"features.{base}.weight"] = _conv(p[f"Conv_{layer}"]["kernel"])
        sd[f"features.{base}.bias"] = _t(p[f"Conv_{layer}"]["bias"])
        _bn(sd, f"features.{base + 1}", p[f"BatchNorm_{layer}"], s[f"BatchNorm_{layer}"])
        if squeeze_excitation:
            se = p[f"SEBlock_{layer}"]
            for i, name in ((0, "Dense_0"), (2, "Dense_1")):
                sd[f"features.{base + 4}.excitation.{i}.weight"] = _linear(se[name]["kernel"])
    for i, name in ((0, "Dense_0"), (3, "Dense_1")):
        sd[f"fc.{i}.weight"] = _linear(p[name]["kernel"])
        sd[f"fc.{i}.bias"] = _t(p[name]["bias"])
    return sd


def resnet_state_dict_from_jax(variables, model_type: str = "",
                               D: bool = False) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a JAX ResNet, as numpy arrays -> the
    port's state dict under export_resnet_state_dict's names: the stem
    (conv1.{0,1,3,4,6,7}, or conv1 / bn1 without ResNet-C), the blocks and
    their projections (downsample.{0,1}), read off the tree, so every
    factory converts.  D: a ResNet-D, whose strided projections sit at
    downsample.{1,2} behind the average pool; model_type (a factory's name)
    then says which blocks have a stride."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    if "stem1" in p:
        for i, ti in enumerate((0, 3, 6), start=1):
            sd[f"conv1.{ti}.weight"] = _conv(p[f"stem{i}"]["kernel"])
            _bn(sd, f"conv1.{ti + 1}", p[f"stem_bn{i}"], s[f"stem_bn{i}"])
    else:
        sd["conv1.weight"] = _conv(p["stem"]["kernel"])
        _bn(sd, "bn1", p["stem_bn"], s["stem_bn"])
    strided = set()
    if D:
        from ssl_audio_tpu_torch.models.resnet import FACTORIES

        strides = FACTORIES[model_type]().strides[1:]
        strided = {f"layer{i + 1}_0" for i, st in enumerate(strides) if st != (1, 1)}
    for fx in sorted(k for k in p if k.startswith("layer")):
        tp = fx.replace("_", ".")
        for c in (1, 2, 3):
            if f"conv{c}" in p[fx]:
                sd[f"{tp}.conv{c}.weight"] = _conv(p[fx][f"conv{c}"]["kernel"])
                _bn(sd, f"{tp}.bn{c}", p[fx][f"bn{c}"], s[fx][f"bn{c}"])
        if "down_conv" in p[fx]:
            at = 1 if fx in strided else 0
            sd[f"{tp}.downsample.{at}.weight"] = _conv(p[fx]["down_conv"]["kernel"])
            _bn(sd, f"{tp}.downsample.{at + 1}", p[fx]["down_bn"], s[fx]["down_bn"])
    return sd


def vit_state_dict_from_jax(params, batch_stats, spec) -> Dict[str, torch.Tensor]:
    """The JAX MaskedAutoencoderViT's params and batch_stats (numpy arrays)
    -> the port's state dict, under the names of export_vit_state_dict:
    the ConvStem's BatchNorm running statistics and the MAE decoder
    included.  spec: the port's ViTSpec of the model (any in_chans: the
    CIFAR-10 ViT's patch projection takes 3).  The fixed position
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


def load_reference_weights_(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
                            keep: Iterable[str] = ()) -> None:
    """Copy a reference-layout state dict (load_reference_state_dict) into
    `module` as the JAX importer reads it (utils/torch_import.py): every
    parameter and running statistic the module has must be in `sd` with its
    shape (KeyError names a missing one, ValueError a shape); the file's
    other tensors are ignored, and a num_batches_tracked it lacks stays as it
    is.  keep: names of the module's own constants, never read from the
    file.  A ResNet-D file (its
    projection's conv at downsample.1, BN at downsample.2) loads into a
    plain ResNet's downsample.{0,1}, as there."""
    sd, want, keep = dict(sd), module.state_dict(), set(keep)
    want = {k: v for k, v in want.items() if k not in keep}
    for k in [k for k in sd if k.endswith(".downsample.1.weight") and sd[k].dim() == 4]:
        head = k[:-len("1.weight")]                       # "<block>.downsample."
        if head + "0.weight" in want and head + "0.weight" not in sd:
            for i in (1, 2):
                for name in [n for n in sd if n.startswith(f"{head}{i}.")]:
                    sd[f"{head}{i - 1}.{name[len(head) + 2:]}"] = sd.pop(name)
    picked = {}
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            if k in sd:
                picked[k] = sd[k]
            continue
        if k not in sd:
            raise KeyError(f"the checkpoint lacks {k}")
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the checkpoint's shape {tuple(sd[k].shape)}, the "
                             f"model's {tuple(v.shape)}")
        picked[k] = sd[k]
    missing, _ = module.load_state_dict(picked, strict=False)
    assert all(k.endswith("num_batches_tracked") or k in keep for k in missing), missing


def resize_pos_embed(table: torch.Tensor, grid) -> torch.Tensor:
    """A learned (1, 1 + h * w, D) position table of a square h x w grid ->
    (1, 1 + gh * gw, D) for `grid` (gh, gw): the CLS row kept, the patch
    rows resized bicubically (align_corners=False), as the JAX importer's
    interpolate_pos_embed (utils/torch_import.py:125-131).  The same table
    when the token count already fits."""
    gh, gw = grid
    n, d = table.shape[1] - 1, table.shape[-1]
    if n == gh * gw:
        return table
    side = int(round(n ** 0.5))
    if side * side != n:
        raise ValueError(f"a position table of {n} patch rows is not a square grid: "
                         f"its grid cannot be inferred")
    tokens = table[:, 1:].float().reshape(1, side, side, d).permute(0, 3, 1, 2)
    tokens = torch.nn.functional.interpolate(tokens, size=(gh, gw), mode="bicubic",
                                             align_corners=False)
    return torch.cat([table[:, :1].float(), tokens.permute(0, 2, 3, 1).reshape(1, gh * gw, d)],
                     dim=1)


def load_vit_reference_weights_(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                                keep: Iterable[str] = ()) -> None:
    """A reference-layout ViT state dict into `model` (models/vit.py) as the
    JAX importer reads it (utils/torch_import.py:113-201
    load_torch_vit_params): exactly the module's parameters and ConvStem
    running statistics by name and shape (KeyError for a missing one); the
    file's other tensors (head.*, an MAE decoder the model lacks,
    mask_token) are ignored.  The model's fixed sin-cos tables are its own
    constants, whatever the file holds; a learned pos_embed is read and
    resized to the model's grid (resize_pos_embed).  keep: more of the
    module's names to leave as they are."""
    sd = dict(sd)
    if isinstance(model.pos_embed, torch.nn.Parameter) and "pos_embed" in sd:
        sd["pos_embed"] = resize_pos_embed(sd["pos_embed"], model.grid_size())
    fixed = [name for name, _ in model.named_buffers() if name.endswith("pos_embed")]
    load_reference_weights_(model, sd, keep=[*fixed, *keep])


def classifier_head_from_jax(head) -> Dict[str, torch.Tensor]:
    """JAX's classifier head (eval/finetune.py: {"w" (D, C), "b" (C,)}) ->
    the state dict of the port's nn.Linear head (eval/finetune.py)."""
    return {"weight": _linear(head["w"]), "bias": _t(head["b"])}


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


def encoder_state_dict_from_jax(params, batch_stats, vit_spec=None) -> Dict[str, torch.Tensor]:
    """The JAX train state's encoder trees (numpy arrays) -> the port
    encoder's state dict: a ViT's when vit_spec (its ViTSpec) is given; else
    read off the tree, an AudioNTT2022's (its inner "encoder", SE blocks
    where it holds them) or a ResNet's."""
    if vit_spec is not None:
        return vit_state_dict_from_jax(params, batch_stats, vit_spec)
    variables = {"params": params, "batch_stats": batch_stats}
    if "encoder" in params:
        return audiontt_state_dict_from_jax(
            variables, squeeze_excitation="SEBlock_0" in params["encoder"])
    return resnet_state_dict_from_jax(variables)


def train_state_dicts_from_jax(params, batch_stats,
                               vit_spec=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX train state's {"encoder", "head", "predictor"} parameter and
    batch-statistics trees (numpy arrays) -> {"encoder", "head", "predictor"}
    state dicts for the port's modules (train/state.py), so that a step can
    start from the same state in both packages.  vit_spec: the port
    encoder's ViTSpec when it is a ViT (None: a conv encoder, read off the
    tree).  An empty predictor tree (cfg.predictor off) gives an empty
    state dict."""
    out = {"encoder": encoder_state_dict_from_jax(params["encoder"],
                                                  batch_stats.get("encoder"), vit_spec)}
    out["head"] = _mlp_state_dict_from_jax(params["head"], batch_stats["head"], "projector")
    out["predictor"] = _mlp_state_dict_from_jax(
        params.get("predictor") or {}, batch_stats.get("predictor") or {}, "predictor")
    return out


def dino_head_state_dict_from_jax(params, stats=None) -> Dict[str, torch.Tensor]:
    """The JAX DINOHead's tree -> the port's DINOHead state dict: Dense_i
    (kernel transposed, bias) at mlp.{2i} (mlp.{3i}, with BatchNorm_i at
    mlp.{3i+1}, where the head has BatchNorms), last_layer_v (bottleneck,
    out) -> last_layer.weight_v (out, bottleneck), last_layer_g (out,) ->
    last_layer.weight_g (out, 1)."""
    stats = stats or {}
    n_dense = sum(1 for k in params if k.startswith("Dense_"))
    stride = 3 if "BatchNorm_0" in params else 2
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_dense):
        sd[f"mlp.{stride * i}.weight"] = _linear(params[f"Dense_{i}"]["kernel"])
        sd[f"mlp.{stride * i}.bias"] = _t(params[f"Dense_{i}"]["bias"])
        if stride == 3 and i < n_dense - 1:
            _bn(sd, f"mlp.{3 * i + 1}", params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])
    sd["last_layer.weight_g"] = _t(np.asarray(params["last_layer_g"])[:, None])
    sd["last_layer.weight_v"] = _linear(params["last_layer_v"])
    return sd


def byola_head_state_dict_from_jax(params, stats) -> Dict[str, torch.Tensor]:
    """The JAX BYOL-A _MLPHead's tree (Dense_0, BatchNorm_0, Dense_1) -> the
    port's MLPHead state dict (net.0, net.1, net.3)."""
    sd = {"net.0.weight": _linear(params["Dense_0"]["kernel"]),
          "net.0.bias": _t(params["Dense_0"]["bias"])}
    _bn(sd, "net.1", params["BatchNorm_0"], stats["BatchNorm_0"])
    sd["net.3.weight"] = _linear(params["Dense_1"]["kernel"])
    sd["net.3.bias"] = _t(params["Dense_1"]["bias"])
    return sd


def legacy_state_dicts_from_jax(params, batch_stats, method: str, vit_spec=None,
                                center=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One stack of a JAX legacy train state (its params and batch_stats, or
    its target_params and target_batch_stats; numpy arrays) -> the port's
    state dicts (train/legacy_steps.py): {"encoder", "head"} for DINO,
    {"encoder", "head", "predictor"} for BYOL-A, and "center" (the JAX
    state's extra["center"]) as a tensor where it is given.  vit_spec: the
    port encoder's ViTSpec when it is a ViT."""
    out = {"encoder": encoder_state_dict_from_jax(params["encoder"],
                                                  batch_stats.get("encoder"), vit_spec)}
    if method == "dino":
        out["head"] = dino_head_state_dict_from_jax(params["head"], batch_stats.get("head"))
    elif method == "byola":
        out["head"] = byola_head_state_dict_from_jax(params["head"], batch_stats["head"])
        out["predictor"] = byola_head_state_dict_from_jax(params["predictor"],
                                                          batch_stats["predictor"])
    else:
        raise ValueError(f"no legacy family {method!r}")
    if center is not None:
        out["center"] = _t(center)
    return out


def lars_state_from_jax(mu) -> Dict[str, Dict[str, torch.Tensor]]:
    """The LARS momentum tree of the JAX optimizer state (shaped like the
    parameters) of a conv encoder's train state -> per module, momentum
    tensors under the port's parameter names (running statistics are not
    parameters and are left out)."""
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


def mlp_clf_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX MLP probe's parameters (eval/mlp_clf.py: a list of {"w" (in,
    out), "b" (out,)} per layer) -> a state dict of the port's probe, an
    nn.Sequential with its Linear layers at the even indices."""
    sd: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params):
        sd[f"{2 * i}.weight"] = _t(np.asarray(layer["w"]).T)
        sd[f"{2 * i}.bias"] = _t(layer["b"])
    return sd


# ------------------------------------------------- Orbax trees (utils/orbax.py)

_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _is_encoder_tree(t) -> bool:
    """An encoder's own parameter tree: AudioNTT2022's ({"encoder": {Conv_0,
    ...}}), a ResNet's (stem) or a ViT's (cls_token, patch_embed)."""
    return isinstance(t, dict) and (
        (isinstance(t.get("encoder"), dict) and "Conv_0" in t["encoder"])
        or "stem" in t or "stem1" in t or "cls_token" in t or "patch_embed" in t)


def encoder_trees_from_jax(tree, where: str = "the checkpoint"):
    """A tree that a JAX loader reads (utils/orbax.py read_orbax_tree) ->
    (the encoder's parameter tree, its batch-statistics tree or None), as
    JAX's load_encoder_checkpoint and HEAR loaders take them: from a whole
    TrainState (state/params/encoder, the legacy DINO / BYOL-A states' online
    encoder included), a save_params_only tree ({"params": ...}), the
    importer's tree (tools/import_torch_ckpt.py: params/encoder, AudioNTT's
    params/encoder/encoder) or an encoder's own {"params", "batch_stats"}.
    None where the tree holds no statistics (a params-only save): the
    module's own stay.  ValueError names what was found otherwise."""
    src = tree.get("state", tree) if isinstance(tree, dict) else None
    if not isinstance(src, dict) or not isinstance(src.get("params"), dict):
        raise ValueError(f"{where}: no params tree (top-level keys "
                         f"{sorted(tree) if isinstance(tree, dict) else type(tree).__name__})")
    params, stats = src["params"], src.get("batch_stats") or {}
    while not _is_encoder_tree(params):
        if not isinstance(params.get("encoder"), dict):
            raise ValueError(f"{where}: no encoder under params (keys {sorted(params)})")
        params = params["encoder"]
        stats = (stats.get("encoder") or {}) if isinstance(stats, dict) else {}
    return params, (stats or None)


def load_encoder_from_jax_(module: torch.nn.Module, params, stats=None) -> None:
    """The JAX encoder trees (encoder_trees_from_jax) into a port encoder,
    as a reference `.pth` loads (load_reference_weights_,
    load_vit_reference_weights_): every parameter by name and shape.  stats
    None keeps the module's running statistics (JAX's loaders keep their
    template's where the checkpoint has none)."""
    from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT

    vit = isinstance(module, MaskedAutoencoderViT)
    sd = encoder_state_dict_from_jax(
        params, stats if stats is not None else _zero_stats_like(params),
        module.spec if vit else None)
    keep = [k for k in module.state_dict() if k.endswith(_STATS)] if stats is None else []
    if vit:
        load_vit_reference_weights_(module, sd, keep=keep)
    else:
        load_reference_weights_(module, sd, keep=keep)


def _fill_none(tree, like):
    """`tree` with every None leaf (optax keeps no moment for a frozen
    parameter) replaced by zeros shaped like `like`'s leaf."""
    if tree is None:
        return {k: _fill_none(None, v) for k, v in like.items()} if isinstance(like, dict) \
            else np.zeros(np.shape(like), np.float32)
    if isinstance(tree, dict):
        return {k: _fill_none(v, like[k]) for k, v in tree.items()}
    return tree


def moments_from_jax(opt_state) -> dict:
    """The optimizer state of a JAX train state (as read) -> {"kind":
    "lars" | "adamw" | "adam" | "sgd", "count": the updates taken, "mu",
    "nu": moment trees or None}, for every optimizer train/optim.py builds:
    LARS ({count, mu}), optax.adamw / adam / sgd under inject_hyperparams
    (count, hyperparams, inner_state with ScaleByAdamState {count, mu,
    nu}), the legacy DINO AdamW (the same) and BYOL-A's plain adam (a chain:
    [{count, mu, nu}, None]), each inside multi_transform's "train" branch
    where a parameter is frozen."""
    if isinstance(opt_state, dict) and "inner_states" in opt_state:
        opt_state = opt_state["inner_states"]["train"]["inner_state"]
    hyper = opt_state.get("hyperparams") if isinstance(opt_state, dict) else None

    def find(node):
        if isinstance(node, dict):
            if "mu" in node:
                return node
            node = node.get("inner_state")
        if isinstance(node, (list, dict)):
            for v in (node if isinstance(node, list) else [node]):
                hit = find(v)
                if hit is not None:
                    return hit
        return None

    m = find(opt_state)
    if m is not None and "nu" not in m:
        return {"kind": "lars", "count": int(m["count"]), "mu": m["mu"], "nu": None}
    if hyper is not None:
        count = int(opt_state["count"])
    elif m is not None:
        count = int(m["count"])
    else:
        raise ValueError(f"no optimizer moments or step count in the checkpoint's "
                         f"optimizer state ({type(opt_state).__name__})")
    if m is None:
        return {"kind": "sgd", "count": count, "mu": None, "nu": None}
    kind = "adamw" if hyper is not None and "weight_decay" in hyper else "adam"
    return {"kind": kind, "count": count, "mu": m["mu"], "nu": m["nu"]}


def _stack_state_dict(tree, stats, method, vit_spec, prefix="") -> Dict[str, torch.Tensor]:
    """One stack's trees -> one flat state dict under the modules' names."""
    if method is None:
        sds = train_state_dicts_from_jax(tree, stats, vit_spec)
    else:
        sds = legacy_state_dicts_from_jax(tree, stats, method, vit_spec)
    return {f"{prefix}{m}.{k}": v for m, sd in sds.items() for k, v in sd.items()}


def _moment_state_dict(mu, params, method, vit_spec) -> Dict[str, torch.Tensor]:
    """A moment tree shaped like the parameters (or [online, target] where
    one optimizer spans both BYOL stacks) -> moments under the parameters'
    names."""
    if isinstance(mu, list):
        online, target = params
        return {**_moment_state_dict(mu[0], online, method, vit_spec),
                **{f"target.{k}": v
                   for k, v in _moment_state_dict(mu[1], target, method, vit_spec).items()}}
    mu = _fill_none(mu, params)
    sd = _stack_state_dict(mu, _zero_stats_like(mu), method, vit_spec)
    return {k: v for k, v in sd.items() if not k.endswith(_STATS)}


def _optimizer_kind(optimizer) -> str:
    from ssl_audio_tpu_torch.train.optim import LARS

    if isinstance(optimizer, LARS):
        return "lars"
    if isinstance(optimizer, torch.optim.AdamW):
        return "adamw"
    return "adam" if isinstance(optimizer, torch.optim.Adam) else "sgd"


def train_state_dict_from_jax(tree, state, method: str | None = None) -> dict:
    """A whole JAX train state as read (utils/orbax.py; {"state", "epoch"})
    -> (the port's TrainState.state_dict() for `state`, the epoch the JAX
    run would resume at).  state: the port's train state of the same
    configuration (train/state.py init_train_state, or
    train/legacy_steps.py init_legacy_state for method "dino" / "byola"),
    which gives the modules' names, the optimizer's groups and the
    augmentation parts.  Carries the parameters and running statistics of
    every stack (the BYOL and legacy targets too), the optimizer's moments
    (LARS momentum; Adam / AdamW mu, nu and count) and step count, the LR
    schedule's position, the mixup ring, the running norm, the step and
    the DINO centre.  ValueError where the tree is not a train state or
    belongs to another optimizer."""
    if not isinstance(tree, dict) or not isinstance(tree.get("state"), dict):
        raise ValueError(f"not a whole JAX train state (top-level keys "
                         f"{sorted(tree) if isinstance(tree, dict) else type(tree).__name__}); "
                         "a params-only or imported tree carries the encoder alone")
    src = tree["state"]
    enc = state.modules["encoder"]
    vit_spec = getattr(enc, "spec", None) if hasattr(enc, "grid_size") else None
    model = _stack_state_dict(src["params"], src["batch_stats"], method, vit_spec)
    if src.get("target_params") is not None:
        model.update(_stack_state_dict(src["target_params"], src["target_batch_stats"], method,
                                       vit_spec, prefix="target."))
    m = moments_from_jax(src["opt_state"])
    want = _optimizer_kind(state.optimizer)
    if m["kind"] != want:
        raise ValueError(f"the checkpoint's optimizer is {m['kind']}, this configuration's "
                         f"{want} (pass the run's own --optimizer)")
    osd = state.optimizer.state_dict()
    if m["mu"] is not None:
        params = src["params"]
        if isinstance(m["mu"], list):
            params = (src["params"], src["target_params"])
        mus = _moment_state_dict(m["mu"], params, method, vit_spec)
        nus = None if m["nu"] is None else _moment_state_dict(m["nu"], params, method, vit_spec)
        names = {id(p): n for n, p in state.modules.named_parameters()}
        per_param = {}
        for group, saved in zip(state.optimizer.param_groups, osd["param_groups"]):
            for p, i in zip(group["params"], saved["params"]):
                name = names[id(p)]
                if name not in mus:
                    raise ValueError(f"the checkpoint holds no optimizer moment for {name}")
                if tuple(mus[name].shape) != tuple(p.shape):
                    raise ValueError(f"{name}: the checkpoint's moment has the shape "
                                     f"{tuple(mus[name].shape)}, the parameter {tuple(p.shape)}")
                if nus is None:
                    per_param[i] = {"mu": mus[name]}
                else:
                    per_param[i] = {"step": torch.tensor(float(m["count"])),
                                    "exp_avg": mus[name], "exp_avg_sq": nus[name]}
        osd["state"] = per_param
    if want == "lars":
        osd["count"] = m["count"]
    sched = None
    if state.scheduler is not None:
        sched = state.scheduler.state_dict()
        sched["last_epoch" if "last_epoch" in sched else "count"] = m["count"]
    return {"model": model, "optimizer": osd, "scheduler": sched,
            "augment": _augment_from_jax(src.get("aug"), state),
            "step": int(src["step"]),
            **({"center": _t(src["extra"]["center"])} if method == "dino" else {})
            }, int(tree["epoch"])


def _augment_from_jax(aug, state) -> dict:
    """The JAX AugmentState (mixup ring, running norm) -> the port's
    AugmentState.state_dict().  A CIFAR-10 state's ring is left out (the
    port keeps none: CIFAR views never read it)."""
    aug = aug or {}
    out = {}
    for name, part in (("mixup", state.aug.mixup), ("running_norm", state.aug.running_norm)):
        src = aug.get(name)
        if part is None:
            if src is not None and state.cfg.dataset != "cifar10":
                raise ValueError(f"the checkpoint has a {name} state, this configuration none")
            out[name] = None
        elif src is None:
            raise ValueError(f"the checkpoint has no {name} state, this configuration one")
        elif name == "mixup":
            out[name] = {"bank": _t(src["bank"]), "count": int(src["count"]),
                         "pos": int(src["pos"])}
        else:
            if int(src["n"]) != int(src["s2_n"]):
                raise ValueError(f"running norm: n {int(src['n'])} != s2_n {int(src['s2_n'])}")
            out[name] = {"mu": _t(src["mu"]), "s2": _t(src["s2"]), "n": int(src["n"])}
    return out


def reference_state_dict_from_jax(params, stats, model_type: str, vit_spec=None,
                                  squeeze_excitation: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX encoder's trees (encoder_trees_from_jax) -> the reference-layout
    state dict that the JAX package's tools/export_torch_ckpt.py writes for
    them (utils/torch_export.py), key for key and value for value: a ViT's
    (vit_spec: its ViTSpec) with the fixed sin-cos tables recomputed as 2-D
    tables with a CLS row (the decoder's too, at its width) and a ConvStem
    without statistics at mean 0 / var 1; AudioNTT2022's with SE blocks
    where the tree has them or squeeze_excitation asks; a ResNet's."""
    from ssl_audio_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed

    stats = stats or {}
    if vit_spec is not None:
        pe = params["patch_embed"]
        bn = dict(stats.get("patch_embed", {}))
        for i in range(len([k for k in pe if k.startswith("conv")])):
            scale = np.asarray(pe[f"bn{i}"]["scale"], np.float32)
            have = bn.get(f"bn{i}", {})
            bn[f"bn{i}"] = {"mean": have.get("mean", np.zeros_like(scale)),
                            "var": have.get("var", np.ones_like(scale))}
        sd = vit_state_dict_from_jax(params, {"patch_embed": bn}, vit_spec)
        grid = (vit_spec.img_size[0] // vit_spec.patch_size[0],
                vit_spec.img_size[1] // vit_spec.patch_size[1])
        if "decoder_embed" in params:
            dim = int(np.asarray(params["decoder_embed"]["kernel"]).shape[1])
            sd["decoder_pos_embed"] = _t(get_2d_sincos_pos_embed(dim, grid)[None])
        return sd
    variables = {"params": params, "batch_stats": stats}
    if model_type == "audiontt":
        se = squeeze_excitation or "SEBlock_0" in params.get("encoder", {})
        return audiontt_state_dict_from_jax(variables, squeeze_excitation=se)
    return resnet_state_dict_from_jax(variables)
