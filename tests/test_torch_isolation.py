"""The port (ssl_audio_tpu_torch) and chip_smoke.py stand alone: they import
torch and never jax or anything of the JAX package ssl_audio_tpu, nor
scikit-learn or PyYAML (the card's machine has neither; the one exception
is `--config`'s reader in config.py, which imports PyYAML when called and
names the package when it is missing), nor, when a module is imported,
flax, orbax, tensorstore, optuna, wandb or matplotlib (the functions that
need them import them), name no path
under the JAX side's native/ or ssl_audio_tpu/ (the port builds its own
copies of the C++ readers), and chip_smoke.py refuses to run without a CUDA
device or without the repo."""
import ast
import os
import re
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
             or k.split(".")[0] in ("sklearn", "yaml", "flax", "orbax", "tensorstore",
                                    "optuna", "wandb", "matplotlib"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
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
                 "eval.linear", "data.datasets", "data.native_loader", "linear",
                 "tools.wav_to_lms", "tools.bench_pipeline", "tools.sweep",
                 "augment.augmentations", "ops", "tools.step_determinism", "tools.eager_ab",
                 "main_bt_byol", "tools.reproduce", "hear.extract_results",
                 "models.resnet", "models.audiontt", "utils.weights", "hear.pipeline",
                 "parallel", "data.cifar10", "augment.cifar", "eval.cifar_knn",
                 "augment.spec_augment", "augment.mask_conv", "eval.finetune", "evaluate",
                 "extract_embeddings", "utils.orbax", "utils.metric_logger", "utils.plotting",
                 "utils.flops", "tools.convert_checkpoint", "run_hyperparameter_sweep"):
        assert f"ssl_audio_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _guarded_yaml_imports(path: Path) -> int:
    """The number of `import yaml` statements of `path`, each of which must
    sit in a function, inside a try whose handler catches ImportError."""
    n = 0

    def visit(node, in_function, guarded):
        nonlocal n
        if isinstance(node, ast.Import) and any(a.name.split(".")[0] == "yaml"
                                                for a in node.names):
            assert in_function and guarded, (path, node.lineno)
            n += 1
        for child in ast.iter_child_nodes(node):
            catches = isinstance(node, ast.Try) and child in node.body and any(
                isinstance(h.type, ast.Name) and h.type.id in ("ImportError",
                                                               "ModuleNotFoundError")
                for h in node.handlers)
            visit(child, in_function or isinstance(node, ast.FunctionDef),
                  guarded or catches)

    visit(ast.parse(path.read_text()), False, False)
    return n


def test_sources_name_no_jax_import():
    """Every import statement of the port and of chip_smoke.py, lazy ones
    included: the `ssl_audio_tpu_torch` prefix must not pass for
    `ssl_audio_tpu`.  PyYAML only in config.py's `--config` reader, imported
    when it is called, an ImportError caught there."""
    files = sorted((REPO / "ssl_audio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    config = REPO / "ssl_audio_tpu_torch" / "config.py"
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "ssl_audio_tpu", "sklearn"), (f, name)
            assert root != "yaml" or f == config, (f, name)
    assert _guarded_yaml_imports(config) == 1


JAX_SIDE_DIRS = ("native", "ssl_audio_tpu")
JAX_SIDE_PATH = re.compile(r"(^|/)(native|ssl_audio_tpu)/")


def _jax_side_components(tree):
    """`x / "native"` and `join(..., "native", ...)` (or "ssl_audio_tpu") where
    the component before is not "build" (build/native/ is the port's own
    build directory)."""
    def const(node):
        return node.value if isinstance(node, ast.Constant) else None

    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and const(node.right) in JAX_SIDE_DIRS:
            before = node.left.right if isinstance(node.left, ast.BinOp) else node.left
            if const(before) != "build":
                yield const(node.right)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "join":
            args = [const(a) for a in node.args]
            for i, a in enumerate(args):
                if a in JAX_SIDE_DIRS and (i == 0 or args[i - 1] != "build"):
                    yield a


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def test_sources_name_no_jax_side_path():
    """No string in the port's code (docstrings aside, which cite the JAX
    modules a part was ported from; chip_smoke.py's kernel table cites the
    TPU kernels by file and line) names a path under native/ or
    ssl_audio_tpu/: the C++ readers are built from the port's own csrc/
    copies, and those copies are the JAX side's byte for byte."""
    from ssl_audio_tpu_torch.data import native_loader

    for f in sorted((REPO / "ssl_audio_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        docs = {id(d) for d in _docstrings(tree)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert not JAX_SIDE_PATH.search(node.value), (f, node.value)
        assert list(_jax_side_components(tree)) == [], f
    assert native_loader.NATIVE_SRC == REPO / "ssl_audio_tpu_torch" / "csrc"
    for source in native_loader.SIGNATURES:
        ours = native_loader.NATIVE_SRC / source
        assert ours.read_bytes() == (REPO / "native" / source).read_bytes()
        assert native_loader.library_path(source).parent == REPO / "build" / "native"


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
