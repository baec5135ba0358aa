"""The port (ssl_audio_tpu_torch) and chip_smoke.py stand alone: they import
torch and never jax or anything of the JAX package ssl_audio_tpu, nor
scikit-learn or PyYAML (the card's machine has neither), and
chip_smoke.py refuses to run without a CUDA device or without the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import ssl_audio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ssl_audio_tpu_torch.__path__,
                                               "ssl_audio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k == "ssl_audio_tpu" or k.startswith("ssl_audio_tpu.")
             or k.split(".")[0] in ("sklearn", "yaml"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ssl_audio_tpu_torch.hear.conv" in result["modules"]
    assert "ssl_audio_tpu_torch.ops.mel_kernel" in result["modules"]
    for name in ("main", "config", "train.loop", "train.steps", "train.state",
                 "train.optim", "augment.transforms", "objectives.barlow",
                 "models.heads", "data.pipeline", "tools.train_profile", "models.vit",
                 "ops.fused_attention", "ops.pos_embed", "utils.schedules", "hear.vit",
                 "eval.encode", "eval.stats", "eval.mlp_clf", "eval.low_shot", "eval.knn",
                 "eval.linear"):
        assert f"ssl_audio_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_sources_name_no_jax_import():
    """Every import statement of the port and of chip_smoke.py, lazy ones
    included: the `ssl_audio_tpu_torch` prefix must not pass for
    `ssl_audio_tpu`."""
    files = sorted((REPO / "ssl_audio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "ssl_audio_tpu", "yaml", "sklearn"), (f, name)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No CUDA device here: non-zero exit and no result line.  Alone in an
    empty directory it fails as well."""
    runs = [REPO]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    runs.append(alone)
    for cwd in runs:
        if cwd == REPO and torch.cuda.is_available():
            continue
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, env=_env(), timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
