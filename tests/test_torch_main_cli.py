"""The port's training entry point, run as a user would: python -m
ssl_audio_tpu_torch.main.  With --device cpu it takes two small steps and
exits 0; without it, on a machine with no card, it exits non-zero and
prints no result: an entry point never drops to the CPU on its own.  Each
run works in a temporary directory, where main writes its checkpoints and
CSV log.  The first test starts a new interpreter; the others run the
module in this process as -m runs it (run_here), since a new interpreter
spends seconds importing torch under the suite's load.  Also in this
process: `--config FILE.yaml` (config.py parse_config) against JAX's
config_from_args on the same file and argv, field for field, and the
settings `--distributed` still refuses for the legacy families and
CIFAR-10."""
import dataclasses
import os
import runpy
import subprocess
import sys
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from ssl_audio_tpu.config import config_from_args as jax_config_from_args
from ssl_audio_tpu_torch import main as port_main
from ssl_audio_tpu_torch import main_pretrain
from ssl_audio_tpu_torch.config import config_from_args
from ssl_audio_tpu_torch.linear import main as linear_main
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--dataset", "synthetic_wav", "--batch_size", "4", "--epochs", "1",
         "--synthetic_steps_per_epoch", "2", "--crop_frames", "32",
         "--projector_hidden_dim", "256", "--num_workers", "2"]


def run(cwd, *args):
    """python -m ssl_audio_tpu_torch.main *args in the directory `cwd`, with
    the repository on the import path and one intra-op thread (the suite
    runs six workers on the host's cores: a pool of threads per process
    waits on its stragglers at every small op)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ssl_audio_tpu_torch.main", *args],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=600)


@pytest.fixture
def run_here(monkeypatch, capsys):
    """run(cwd, *args) in this process: ssl_audio_tpu_torch.main as -m runs
    it (runpy, the module as __main__, sys.argv its arguments;
    tests/test_torch_finetune.py run_cli), with run()'s result: an
    exception that escapes gives return code 1 and its traceback on the
    standard error, as the interpreter prints it."""
    def run_in_process(cwd, *args):
        monkeypatch.chdir(cwd)
        monkeypatch.setattr(sys, "argv", ["ssl_audio_tpu_torch.main", *args])
        capsys.readouterr()
        rc, trace = 0, ""
        try:
            with warnings.catch_warnings():     # the module is imported already
                warnings.simplefilter("ignore", RuntimeWarning)
                runpy.run_module("ssl_audio_tpu_torch.main", run_name="__main__",
                                 alter_sys=True)
        except Exception as e:
            rc, trace = 1, "".join(traceback.format_exception(e))
        out = capsys.readouterr()
        return SimpleNamespace(returncode=rc, stdout=out.out, stderr=out.err + trace)

    return run_in_process


def test_two_steps_on_the_cpu(tmp_path):
    out = run(tmp_path, "--device", "cpu", *SMALL)
    assert out.returncode == 0, out.stderr
    assert "Epoch [1/1] loss=" in out.stdout and "on cpu" in out.stdout
    assert "epoch,1,step,0,loss," in out.stdout
    # no FSD50K data: the per-epoch probe is off, as the JAX main says
    assert "Epoch eval disabled" in out.stdout
    (ckpt,) = list(tmp_path.glob("results/synthetic_wav/*/model_1.pt"))
    (log,) = list(tmp_path.glob("logs/training/synthetic_wav/*/log.csv"))
    assert log.read_text().startswith("epoch,1,step,0,loss,")


def test_synthetic_log_mel_dataset_with_adamw(tmp_path, run_here):
    out = run_here(tmp_path, "--device", "cpu", *SMALL[2:], "--dataset", "synthetic",
                   "--optimizer", "AdamW", "--lr", "1e-3", "--wd", "0.05", "--lr_schedule")
    assert out.returncode == 0, out.stderr
    assert "Epoch [1/1] loss=" in out.stdout


def test_vit_tiny_with_fused_attention_on_the_cpu(tmp_path, run_here):
    """The ViT slice's entry point at a small size: vit_tiny, the attention's
    plain versions, the teacher masked by token drop."""
    out = run_here(tmp_path, "--device", "cpu", *SMALL, "--model_type", "vit_tiny",
                   "--fused_attention", "--mask", "--mask_ratio", "0.75")
    assert out.returncode == 0, out.stderr
    assert "training vit_tiny" in out.stdout and "AdamW" in out.stdout
    assert "Epoch [1/1] loss=" in out.stdout and "on cpu" in out.stdout


def test_without_a_card_it_fails_and_prints_no_result(tmp_path, run_here):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    for extra in ([], ["--model_type", "vit_base", "--fused_attention"]):
        out = run_here(tmp_path, *SMALL, *extra)
        assert out.returncode != 0
        assert "Epoch [" not in out.stdout and "loss" not in out.stdout
        assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("flags", [["--fsdp"], ["--model_parallel", "2"],
                                   ["--distributed", "--model_parallel", "2"],
                                   ["--distributed", "--fsdp"], ["--data_axis_size", "3"],
                                   ["--model_type", "vit_tiny", "--layout_barrier"]])
def test_deferred_flags_parse_and_raise(flags, tmp_path, run_here):
    out = run_here(tmp_path, "--device", "cpu", *SMALL, *flags)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "not ported yet" in out.stderr
    assert "Epoch [" not in out.stdout
    assert not any(tmp_path.iterdir())          # refused before anything is written


def test_resume_path(tmp_path, run_here):
    """A --resume_path that does not exist fails with FileNotFoundError
    before any training; a checkpoint of a 2-epoch run resumes at epoch 2 of
    the same run with --epochs 2 given again, and finishes it."""
    out = run_here(tmp_path, "--device", "cpu", *SMALL, "--resume_path", "ckpt")
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr and "Epoch [" not in out.stdout
    argv = ["--device", "cpu", *SMALL[:4], "--epochs", "2", *SMALL[6:],
            "--epoch_save_f", "1", "--save_base_dir", "a"]
    out = run_here(tmp_path, *argv)
    assert out.returncode == 0, out.stderr
    assert "Epoch [2/2]" in out.stdout
    (first,) = list(tmp_path.glob("a/results/synthetic_wav/*/model_1.pt"))
    out = run_here(tmp_path, *argv[:-1], "b", "--resume_path", str(first))
    assert out.returncode == 0, out.stderr
    assert f"Resumed from {first} at epoch 2" in out.stdout
    assert "Epoch [1/2]" not in out.stdout and "Epoch [2/2]" in out.stdout
    assert list(tmp_path.glob("b/results/synthetic_wav/*/model_2.pt"))


# a legacy recipe's yaml: nested sections at several depths, the reference's
# key names (JAX config_from_args' aliases), a None that is skipped, a key
# that is no field
RECIPE = """
optimization:
  base_lr: 0.002
  final_weight_decay: 0.3
  weight_decay: 0.05
  loss:
    lambd: 0.004
data:
  batch_size_per_gpu: 64
  crops:
    deeper:
      out_dim: 1024
      local_crops_number: 2
model:
  model_type: vit_tiny
  pool_reorder: true
  ema_decay: 0.95
  mixup: null
  not_a_field: 3
save_epoch_it: 2
epochs: 9
"""


@pytest.mark.parametrize("argv", [[], ["--no_pool_reorder", "--epochs=3"],
                                  ["--batch_size", "32", "--wd", "0.1", "--lmbda", "0.01"]])
def test_config_yaml_equals_jax_config_from_args(tmp_path, argv):
    """Every Config field of the port's config_from_args equals JAX's on the
    same yaml and argv: the aliases, the flattening, the flags that win
    (`--no_pool_reorder` over a yaml `pool_reorder: true`, through the
    parser's option-to-dest table).  batch_size_per_gpu lands in
    batch_size, the global batch in both packages (the copied quirk)."""
    path = tmp_path / "recipe.yaml"
    path.write_text(RECIPE)
    args = ["--config", str(path), *argv]
    got, want = config_from_args(args), jax_config_from_args(args)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert {f.name for f in dataclasses.fields(got)} - {f.name for f in dataclasses.fields(want)} \
        == {"device"}
    assert got.batch_size == (32 if "32" in argv else 64)
    assert got.lr == got.base_lr == 0.002 and got.dino_out_dim == 1024
    assert got.pool_reorder is ("--no_pool_reorder" not in argv) and got.mixup is True
    # main_pretrain and linear take it too (their own flags beside it)
    cfg, method = main_pretrain.config_for(["--method", "dino", *args])
    assert method == "dino" and cfg.dino_out_dim == 1024 and cfg.moving_average_decay == 0.95
    assert cfg.local_crops_number == 2 and cfg.final_wd == 0.3


def test_config_without_pyyaml_names_the_package(tmp_path, monkeypatch):
    path = tmp_path / "recipe.yaml"
    path.write_text(RECIPE)
    monkeypatch.setitem(sys.modules, "yaml", None)          # import yaml fails
    for entry in (config_from_args, lambda a: main_pretrain.config_for(["--method", "byola", *a]),
                  lambda a: linear_main(["--device", "cpu", *a])):
        with pytest.raises(ModuleNotFoundError, match="PyYAML"):
            entry(["--config", str(path)])


@pytest.mark.parametrize("entry", ["dino", "byola", "cifar10"])
@pytest.mark.parametrize("flags", [["--model_parallel", "2"], ["--fsdp"],
                                   ["--data_axis_size", "3"]])
def test_distributed_still_refuses_tp_fsdp_and_another_data_axis(entry, flags, tmp_path,
                                                                   monkeypatch):
    """--distributed runs the legacy families and CIFAR-10 now; with tensor
    parallelism, FSDP or a data axis other than the world size it raises
    NotImplementedError before joining a process group or writing
    anything."""
    monkeypatch.chdir(tmp_path)
    small = ["--device", "cpu", "--distributed", "--batch_size", "8", "--epochs", "1", *flags]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        if entry == "cifar10":
            port_main.main(["--dataset", "cifar10", "--model_type", "vit_tiny", *small])
        else:
            main_pretrain.main(["--method", entry, "--dataset", "synthetic", *small])
    assert not torch.distributed.is_initialized() and not any(tmp_path.iterdir())
