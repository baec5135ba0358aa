"""Weights for the port's AudioNTT2022 (port of the AudioNTT parts of
ssl_audio_tpu/utils/torch_export.py and utils/torch_import.py).

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
