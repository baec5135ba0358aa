"""Weights for the port's AudioNTT2022 (port of the AudioNTT parts of
ssl_audio_tpu/utils/torch_export.py and utils/torch_import.py) and for the
whole train state (encoder, projector, predictor, LARS momentum).

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


def audiontt_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """{"params": {"encoder": ...}, "batch_stats": {"encoder": ...}} of the
    JAX AudioNTT2022, as numpy arrays -> the port's state dict."""
    p = variables["params"]["encoder"]
    s = variables["batch_stats"]["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    for layer in range(2):
        base = 4 * layer
        sd[f"features.{base}.weight"] = _t(np.transpose(
            np.asarray(p[f"Conv_{layer}"]["kernel"]), (3, 2, 0, 1)))
        sd[f"features.{base}.bias"] = _t(p[f"Conv_{layer}"]["bias"])
        bn, stats = p[f"BatchNorm_{layer}"], s[f"BatchNorm_{layer}"]
        sd[f"features.{base + 1}.weight"] = _t(bn["scale"])
        sd[f"features.{base + 1}.bias"] = _t(bn["bias"])
        sd[f"features.{base + 1}.running_mean"] = _t(stats["mean"])
        sd[f"features.{base + 1}.running_var"] = _t(stats["var"])
        sd[f"features.{base + 1}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for i, name in ((0, "Dense_0"), (3, "Dense_1")):
        sd[f"fc.{i}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
        sd[f"fc.{i}.bias"] = _t(p[name]["bias"])
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
            bn, st = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
            base = f"{prefix}.{3 * i + 1}"
            sd[f"{base}.weight"] = _t(bn["scale"])
            sd[f"{base}.bias"] = _t(bn["bias"])
            sd[f"{base}.running_mean"] = _t(st["mean"])
            sd[f"{base}.running_var"] = _t(st["var"])
            sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def train_state_dicts_from_jax(params, batch_stats) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX train state's {"encoder", "head", "predictor"} parameter and
    batch-statistics trees (numpy arrays) -> {"encoder", "head", "predictor"}
    state dicts for the port's modules (train/state.py), so that a step can
    start from the same state in both packages.  An empty predictor tree
    (cfg.predictor off) gives an empty state dict."""
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
