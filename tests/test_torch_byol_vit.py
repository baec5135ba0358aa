"""The BYOL-style variant of the port with a ViT, and through its loop and
entry point, on the CPU at small sizes: two BYOL steps of vit_tiny against
the JAX package's make_byol_train_step (the helpers and tolerances of
tests/test_torch_byol.py), BYOL windows of --steps_per_dispatch N against
single steps, and main_bt_byol's checkpoints, resume and serving."""
import glob

import jax
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu_torch import main_bt_byol
from ssl_audio_tpu_torch.config import config_from_args, default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import (
    make_byol_train_step,
    make_device_frontend,
    pass_sizes,
)
from tests.test_torch_byol import (
    B,
    L,
    SMALL,
    TOL,
    VIEWS_ATOL,
    VIT_KW,
    VIT_MOMENT_TOL,
    JaxViews,
    compare,
    jsnapshot,
    load_from_jax,
    one_intra_op_thread,  # noqa: F401  (autouse fixture)
    snapshot,
)
from tests.test_torch_multi_dispatch import assert_tree_equal
from tests.test_torch_train_step import STATS, port_draws
from tests.test_torch_vit import JaxDraws


@pytest.fixture
def small_vits(monkeypatch):
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})


def test_two_vit_byol_steps_match_jax(monkeypatch, small_vits):
    """vit_tiny (width 64, depth 2) with --masked_recon (the mean of the two
    online recon losses) and a local crop, LARS, the online passes masked
    at 0.5: by key bias at the first step, by token drop (len_keep 4) at the
    second; the JAX side on its einsum attention, the same token-mask noise
    on both sides."""
    kw = {**VIT_KW, "mask": True, "mask_ratio": 0.5, "masked_recon": True,
          "local_crops_number": 1}
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2, byol=True)
    views = JaxViews(mods, jcfg, monkeypatch)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=True,
                             device="cpu")
    spec = state.modules["encoder"].spec
    load_from_jax(state, jstate, spec)
    step = make_byol_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    rng = np.random.default_rng(0)
    sizes = [(f // 16) * (t // 16) for f, t in pass_sizes(cfg, byol=True)]
    assert sizes == [8, 8, 8, 8, 1]
    for i, len_keep in enumerate((None, 4)):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        noise = [rng.random((B, 8)).astype(np.float32) for _ in range(2)]
        monkeypatch.setattr(jvit, "jax", JaxDraws(noise=list(noise)))
        key = jax.random.key(100 + i)
        before, jbefore = snapshot(state), jsnapshot(jstate, spec)
        jstate, jmetrics = views.step(jstate, wav, key, 0.5, len_keep=len_keep)
        draws = port_draws(key, cfg)
        draws.dropout = None
        draws.noise = [torch.from_numpy(n) for n in noise] + [torch.rand(B, n) for n in sizes[2:]]
        metrics = step(state, torch.from_numpy(wav), draws=draws, mask_ratio=0.5,
                       len_keep=len_keep)
        for k in ("loss", "bt_loss", "recon_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL,
                                       atol=1e-6, err_msg=f"{k} of step {i}")
        assert float(metrics["recon_loss"]) > 0
        compare(state, jstate, before, jbefore, vit_spec=spec, moment_tol=VIT_MOMENT_TOL)
    assert max(views.gaps) <= VIEWS_ATOL
    assert len(views.views) == 3


# ------------------------------------------------ windows, entry point, probe

WINDOW_CASES = {
    "audiontt_ema_wav": ["--dataset", "synthetic_wav", "--stop_gradient", "--lr_schedule"],
    "audiontt_by_gradient": ["--dataset", "synthetic"],
    "vit_tiny_masked_ema_adamw": ["--dataset", "synthetic_wav", "--model_type", "vit_tiny",
                                  "--optimizer", "AdamW", "--lr", "1e-3", "--stop_gradient",
                                  "--mask", "--random_mask_ratio"],
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_byol_windows_equal_single_steps_bit_for_bit(small_vits, case):
    """5 BYOL steps at N = 3 (a window and a 2-step tail) against 5 single
    steps through the Trainer from the same seed: losses, both stacks,
    optimizer state, counters and generator, bit for bit."""
    runs = []
    for n in ("1", "3"):
        cfg = config_from_args([*SMALL, *WINDOW_CASES[case], "--epochs", "1",
                                "--synthetic_steps_per_epoch", "5", "--steps_per_dispatch", n])
        tr = Trainer(cfg, byol=True, log=lambda line: None)
        tr.train_one_epoch(1)
        runs.append(tr)
    single, multi = runs
    assert multi.epoch_losses == single.epoch_losses
    assert_tree_equal(multi.state.state_dict(), single.state.state_dict(), "state")
    assert multi.state.step == single.state.step == 5
    assert torch.equal(multi.gen.get_state(), single.gen.get_state())
    assert any(k.startswith("target.") for k in multi.state.state_dict()["model"])


def test_main_bt_byol_checkpoint_resume_and_serving(tmp_path, monkeypatch):
    """main_bt_byol --device cpu: the BYOL save name, a checkpoint with the
    target and the optimizer; a run resumed from model_1.pt ends bit for bit
    where the uninterrupted one does; hear.conv.load_model on the file
    serves the ONLINE encoder, and so does the linear CLI's loader."""
    from ssl_audio_tpu_torch import linear
    from ssl_audio_tpu_torch.hear import conv as hear_conv

    monkeypatch.chdir(tmp_path)
    argv = [*SMALL, "--dataset", "synthetic_wav", "--stop_gradient", "--epochs", "2",
            "--synthetic_steps_per_epoch", "2", "--epoch_save_f", "1", "--no_eval"]
    full = main_bt_byol.main(argv + ["--save_base_dir", "a"])
    (ck1,) = glob.glob("a/results/synthetic_wav/audiontt_byol_2_epochs*/model_1.pt")
    (ck2,) = glob.glob("a/results/synthetic_wav/audiontt_byol_2_epochs*/model_2.pt")
    assert glob.glob("logs/training/synthetic_wav/audiontt_byol_2_epochs*/log.csv")
    resumed = main_bt_byol.main(argv + ["--save_base_dir", "r", "--resume_path", ck1])
    assert resumed.epoch_losses == {2: full.epoch_losses[2]}
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict(), "state")
    named = main_bt_byol.main([*SMALL, "--dataset", "synthetic_wav", "--epochs", "1",
                               "--synthetic_steps_per_epoch", "1", "--no_eval", "--name", "x",
                               "--save_base_dir", "n"])
    assert glob.glob("n/results/synthetic_wav/audiontt_byol_x*/model_1.pt") and named.byol

    ck = torch.load(ck2, weights_only=True)
    assert any(k.startswith("target.encoder.") for k in ck["model"])
    served = hear_conv.load_model(ck2, device="cpu")
    online = full.state.modules["encoder"].state_dict()
    for k, v in served.model.state_dict().items():
        assert torch.equal(v, online[k]), k
    target = full.state.modules["target"]["encoder"].state_dict()
    assert any(not torch.equal(target[k], online[k]) for k in online)
    probed = linear.load_model(config_from_args(SMALL), ck2)
    assert_tree_equal(probed.state_dict(), online, "linear CLI encoder")
