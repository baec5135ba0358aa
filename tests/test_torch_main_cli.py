"""The port's training entry point, run as a user would: python -m
ssl_audio_tpu_torch.main.  With --device cpu it takes two small steps and
exits 0; without it, on a machine with no card, it exits non-zero and
prints no result: an entry point never drops to the CPU on its own."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--dataset", "synthetic_wav", "--batch_size", "4", "--epochs", "1",
         "--synthetic_steps_per_epoch", "2", "--crop_frames", "32",
         "--projector_hidden_dim", "256", "--num_workers", "2"]


def run(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "ssl_audio_tpu_torch.main", *args],
                          cwd=REPO, capture_output=True, text=True, env=env, timeout=600)


def test_two_steps_on_the_cpu():
    out = run("--device", "cpu", *SMALL)
    assert out.returncode == 0, out.stderr
    assert "Epoch [1/1] loss=" in out.stdout and "on cpu" in out.stdout
    assert "epoch,1,step,0,loss," in out.stdout


def test_synthetic_log_mel_dataset_with_adamw():
    out = run("--device", "cpu", *SMALL[2:], "--dataset", "synthetic",
              "--optimizer", "AdamW", "--lr", "1e-3", "--wd", "0.05", "--lr_schedule")
    assert out.returncode == 0, out.stderr
    assert "Epoch [1/1] loss=" in out.stdout


def test_vit_tiny_with_fused_attention_on_the_cpu():
    """The ViT slice's entry point at a small size: vit_tiny, the attention's
    plain versions, the teacher masked by token drop."""
    out = run("--device", "cpu", *SMALL, "--model_type", "vit_tiny", "--fused_attention",
              "--mask", "--mask_ratio", "0.75")
    assert out.returncode == 0, out.stderr
    assert "training vit_tiny" in out.stdout and "AdamW" in out.stdout
    assert "Epoch [1/1] loss=" in out.stdout and "on cpu" in out.stdout


def test_without_a_card_it_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    for extra in ([], ["--model_type", "vit_base", "--fused_attention"]):
        out = run(*SMALL, *extra)
        assert out.returncode != 0
        assert "Epoch [" not in out.stdout and "loss" not in out.stdout
        assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("flags", [["--use_fp16"], ["--steps_per_dispatch", "4"],
                                   ["--resume_path", "ckpt"], ["--squeeze_excitation"],
                                   ["--dataset", "fsd50k"], ["--model_type", "resnet18"],
                                   ["--model_type", "vit_tiny", "--remat"]])
def test_deferred_flags_parse_and_raise(flags):
    out = run("--device", "cpu", *SMALL, *flags)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "not ported yet" in out.stderr
    assert "Epoch [" not in out.stdout
