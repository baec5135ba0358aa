"""The port's training entry point, run as a user would: python -m
ssl_audio_tpu_torch.main.  With --device cpu it takes two small steps and
exits 0; without it, on a machine with no card, it exits non-zero and
prints no result: an entry point never drops to the CPU on its own.  Each
run works in a temporary directory, where main writes its checkpoints and
CSV log."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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


def test_synthetic_log_mel_dataset_with_adamw(tmp_path):
    out = run(tmp_path, "--device", "cpu", *SMALL[2:], "--dataset", "synthetic",
              "--optimizer", "AdamW", "--lr", "1e-3", "--wd", "0.05", "--lr_schedule")
    assert out.returncode == 0, out.stderr
    assert "Epoch [1/1] loss=" in out.stdout


def test_vit_tiny_with_fused_attention_on_the_cpu(tmp_path):
    """The ViT slice's entry point at a small size: vit_tiny, the attention's
    plain versions, the teacher masked by token drop."""
    out = run(tmp_path, "--device", "cpu", *SMALL, "--model_type", "vit_tiny", "--fused_attention",
              "--mask", "--mask_ratio", "0.75")
    assert out.returncode == 0, out.stderr
    assert "training vit_tiny" in out.stdout and "AdamW" in out.stdout
    assert "Epoch [1/1] loss=" in out.stdout and "on cpu" in out.stdout


def test_without_a_card_it_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    for extra in ([], ["--model_type", "vit_base", "--fused_attention"]):
        out = run(tmp_path, *SMALL, *extra)
        assert out.returncode != 0
        assert "Epoch [" not in out.stdout and "loss" not in out.stdout
        assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("flags", [["--fsdp"], ["--model_parallel", "2"],
                                   ["--distributed", "--model_parallel", "2"],
                                   ["--dataset", "cifar10"], ["--data_axis_size", "3"],
                                   ["--model_type", "vit_tiny", "--layout_barrier"]])
def test_deferred_flags_parse_and_raise(flags, tmp_path):
    out = run(tmp_path, "--device", "cpu", *SMALL, *flags)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "not ported yet" in out.stderr
    assert "Epoch [" not in out.stdout
    assert not any(tmp_path.iterdir())          # refused before anything is written


def test_resume_path(tmp_path):
    """A --resume_path that does not exist fails with FileNotFoundError
    before any training; a checkpoint of a 2-epoch run resumes at epoch 2 of
    the same run with --epochs 2 given again, and finishes it."""
    out = run(tmp_path, "--device", "cpu", *SMALL, "--resume_path", "ckpt")
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr and "Epoch [" not in out.stdout
    argv = ["--device", "cpu", *SMALL[:4], "--epochs", "2", *SMALL[6:],
            "--epoch_save_f", "1", "--save_base_dir", "a"]
    out = run(tmp_path, *argv)
    assert out.returncode == 0, out.stderr
    assert "Epoch [2/2]" in out.stdout
    (first,) = list(tmp_path.glob("a/results/synthetic_wav/*/model_1.pt"))
    out = run(tmp_path, *argv[:-1], "b", "--resume_path", str(first))
    assert out.returncode == 0, out.stderr
    assert f"Resumed from {first} at epoch 2" in out.stdout
    assert "Epoch [1/2]" not in out.stdout and "Epoch [2/2]" in out.stdout
    assert list(tmp_path.glob("b/results/synthetic_wav/*/model_2.pt"))
