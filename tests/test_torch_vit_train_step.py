"""The ViT training slice as a whole: two consecutive Barlow Twins steps of a
small ViT through the port's step (ssl_audio_tpu_torch/train/steps.py)
against the JAX package's make_train_step (jitted), from the same
parameters, the same raw wav batches and the same random draws, on the CPU.

Fused attention is off on both sides here: the JAX kernel in interpret mode
would cost minutes per step (its own test file pays that once), and the
port's fused step is held against its own fp32 step below, at the bf16
level.  Weight decay is 0: the JAX AdamW decays nothing (its decay mask is
called as a schedule; ROADMAP.md section C), the port decays ndim > 1 as
documented, which test_adamw_decays_weights_not_biases_nor_the_frozen_
projection pins on its own.

Size: the ViT factories' size table is patched to a "tiny" of width 64,
depth 2 and 4 heads on both sides, crop_frames 32 (a 4 x 2 patch grid: 8
tokens), batch 4, projector hidden 256.  Draws: the crop starts and
augmentation parameters are replayed from the JAX step's keys
(tests/test_torch_train_step.port_draws); the token-mask noise is made here
and handed to both (the `jax` the JAX ViT module sees draws it), the same
array at both steps.

Tolerances: fp32, 1e-4 (BASELINE.md) for the losses, relative, and the
running statistics; AdamW's first moment (the gradients' running mean) per
tensor in relative L2 to MOMENT_TOL, for the reason stated there.  The step
each parameter took is not compared: AdamW's first steps are
lr * m / (sqrt(v) + eps), about lr * sign(g) per element, so an element
whose gradient is float noise on both sides (one in ~1e4 of fc1's) moves
the other way by 2 lr."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train import loop as jax_loop
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import make_device_frontend as jax_frontend
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu.utils import schedules as jax_schedules
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train import loop
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import make_device_frontend, make_train_step
from ssl_audio_tpu_torch.utils.schedules import sine_scheduler_increase
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests.test_torch_train_step import STATS, port_draws
from tests.test_torch_vit import JaxDraws


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L, TOKENS = 4, 8000, 8
TOL = 1e-4
# The Barlow Twins loss at B = 4 amplifies fp32 noise: the port's own
# gradients move by ~6e-4 in relative L2 when its views move by 1e-6; against
# JAX (views equal to ~1e-5) the first moments read 1.4e-4..4.5e-4
MOMENT_TOL = 1e-3
# the final LayerNorm's bias shifts every sample's latent alike, which the
# projector's BatchNorm removes: its Barlow Twins gradient is 0 + float noise
# (measured up to 5e-5), to which masked_recon adds a real one
ZERO_GRAD_ATOL = 1e-4
KW = dict(dataset="synthetic_wav", model_type="vit_tiny", batch_size=B, crop_frames=32,
          projector_hidden_dim=256, mixup_n_memory=8, wd=0.0, seed=0)
CASES = {
    "key_bias": (dict(mask=True, mask_ratio=0.75, token_drop=False), 0.75, None),
    "conv_stem_token_drop_recon_mean_pool": (
        dict(model_type="vitc_tiny", mask=True, mask_ratio=0.5, masked_recon=True,
             use_mean_pool=True), 0.5, 4),
}


@pytest.fixture
def small_vits(monkeypatch):
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})


def jax_state_dicts(state, params, batch_stats):
    return train_state_dicts_from_jax(jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, batch_stats),
                                      vit_spec=state.modules["encoder"].spec)


def adam_first_moments(opt_state, params):
    """AdamW's first moment (mu) out of the JAX optimizer state, shaped like
    the parameters; zeros where the frozen label masks it out."""
    found = []

    def visit(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    visit(opt_state)
    assert len(found) == 1
    return jax.tree.map(
        lambda p, m: np.zeros_like(p) if isinstance(m, optax.MaskedNode) else np.asarray(m),
        params, found[0], is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_two_vit_train_steps_match_jax(monkeypatch, small_vits, case):
    options, ratio, len_keep = CASES[case]
    kw = {**KW, **options}
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    jstep = jax_make_train_step(mods, frontend=jax_frontend(jcfg, STATS), donate=False)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    sds = jax_state_dicts(state, jstate.params, jstate.batch_stats)
    for name, module in state.modules.items():
        module.load_state_dict(sds[name], strict=True)
    step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))

    rng = np.random.default_rng(0)
    # the jitted JAX step takes the noise in when it is traced, at the first step
    noise = rng.random((B, TOKENS)).astype(np.float32)
    monkeypatch.setattr(jvit, "jax", JaxDraws(noise=[noise]))
    for i in range(2):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        key = jax.random.key(100 + i)
        before = {k: v.detach().clone() for k, v in state.modules.state_dict().items()}
        jstate, jmetrics = jstep(jstate, jnp.asarray(wav), key, np.float32(ratio),
                                 len_keep=len_keep)
        draws = port_draws(key, cfg)
        draws.dropout = None
        draws.noise = [torch.from_numpy(noise), torch.rand(B, TOKENS)]
        metrics = step(state, torch.from_numpy(wav), draws=draws, mask_ratio=ratio,
                       len_keep=len_keep)
        for k in ("loss", "bt_loss", "recon_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL,
                                       atol=1e-6, err_msg=f"{k} of step {i}")
        want = jax_state_dicts(state, jstate.params, jstate.batch_stats)
        moments = jax_state_dicts(state, adam_first_moments(jstate.opt_state, jstate.params),
                                  jstate.batch_stats)
        for name, module in state.modules.items():
            for k, v in module.state_dict().items():
                if k.endswith(("running_mean", "running_var")) or "pos_embed" in k:
                    close(v, want[name][k], f"{name}.{k}")
            for k, p in module.named_parameters():
                if not p.requires_grad:             # the frozen patch projection
                    assert torch.equal(p, before[f"{name}.{k}"]) and torch.equal(
                        want[name][k], before[f"{name}.{k}"]), k
                    continue
                assert not torch.equal(p, before[f"{name}.{k}"]), f"{name}.{k} did not move"
                m, jm = state.optimizer.state[p]["exp_avg"].double(), moments[name][k].double()
                err = float((m - jm).norm() / jm.norm())
                if f"{name}.{k}" == "encoder.norm.bias":     # BT part: 0 + float noise
                    assert float((m - jm).abs().max()) <= ZERO_GRAD_ATOL
                    continue
                assert err <= MOMENT_TOL, f"first moment of {name}.{k}: relative L2 {err:.2e}"
    assert state.step == int(jstate.step) == 2


def test_fused_step_is_the_fp32_step_at_the_bf16_level(small_vits):
    """The same two steps with --fused_attention (the plain versions of the
    kernels on the CPU) and without: losses within 1e-2 relative, and the
    frozen patch projection unchanged on both."""
    runs = {}
    for fused in (False, True):
        cfg = default_config(**KW, mask=True, mask_ratio=0.75, token_drop=False,
                             fused_attention=fused, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                                 device="cpu")
        proj = state.modules["encoder"].patch_embed.proj.weight.detach().clone()
        step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
        gen = torch.Generator().manual_seed(1)
        wav = torch.from_numpy(
            (0.3 * np.random.default_rng(3).standard_normal((B, L))).astype(np.float32))
        runs[fused] = [float(step(state, wav, gen=gen, mask_ratio=0.75)["loss"])
                       for _ in range(2)]
        assert torch.equal(state.modules["encoder"].patch_embed.proj.weight, proj)
        assert not state.modules["encoder"].patch_embed.proj.weight.requires_grad
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-2)
    assert runs[True] != runs[False]


def test_adamw_decays_weights_not_biases_nor_the_frozen_projection(small_vits):
    """With every gradient 0, AdamW's step is its decoupled decay alone:
    p <- p (1 - lr wd) for ndim > 1, nothing for 1-D parameters, and the
    frozen patch projection is in no parameter group at all."""
    cfg = default_config(**{**KW, "wd": 0.5, "lr": 0.1}, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    named = dict(state.modules.named_parameters())
    in_groups = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    frozen = {k for k in named if k.startswith("encoder.patch_embed")}
    assert frozen == {"encoder.patch_embed.proj.weight", "encoder.patch_embed.proj.bias"}
    assert {k for k, p in named.items() if id(p) not in in_groups} == frozen
    before = {k: p.detach().clone() for k, p in named.items()}
    for k, p in named.items():
        if k not in frozen:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    for k, p in named.items():
        want = before[k] * (1 - 0.1 * 0.5) if (p.ndim > 1 and k not in frozen) else before[k]
        torch.testing.assert_close(p.detach(), want, atol=1e-7, rtol=1e-6, msg=k)
    conv_stem = init_train_state(default_config(**{**KW, "model_type": "vitc_tiny"},
                                                device="cpu"),
                                 torch.Generator().manual_seed(0), device="cpu")
    assert all(p.requires_grad for p in conv_stem.modules.parameters())


def test_mask_ratio_for_step_and_schedule_match_jax():
    """The loop's per-step mask ratio from the same np.random.Generator, for
    a fixed, a random and a scheduled ratio, and the sine schedule itself."""
    np.testing.assert_array_equal(
        sine_scheduler_increase(0.3, 10, 7, warmup_epochs=2, warmup_value=0.0),
        jax_schedules.sine_scheduler_increase(0.3, 10, 7, warmup_epochs=2, warmup_value=0.0))
    schedule = sine_scheduler_increase(0.3, 5, 4, warmup_epochs=1)
    for kw in (dict(), dict(mask=True, mask_ratio=0.6), dict(mask=True, random_mask_ratio=True),
               dict(mask=True, mask_ratio_schedule=True)):
        cfg, jcfg = default_config(**KW, **kw), jax_config(**KW, **kw)
        sched = schedule if kw.get("mask_ratio_schedule") else None
        rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
        got = [loop.mask_ratio_for_step(cfg, sched, it, rng) for it in range(30)]
        want = [jax_loop.mask_ratio_for_step(jcfg, sched, it, jrng) for it in range(30)]
        assert got == want, kw


def test_trainer_picks_token_drop_per_step(small_vits):
    """Token drop at a fixed ratio: len_keep = floor(L (1 - r)); key-bias
    masking with --random_mask_ratio, without --token_drop and at ratio 0."""
    def trainer(**kw):
        return loop.Trainer(default_config(**{**KW, "num_workers": 1, "epochs": 1,
                                               "synthetic_steps_per_epoch": 1},
                                           **kw, device="cpu"), log=lambda *_: None)

    t = trainer(mask=True, mask_ratio=0.75)
    assert (t._static_len_keep(0.75), t._static_len_keep(0.5), t._static_len_keep(0.0)) == \
        (2, 4, None)
    assert t._static_len_keep(0.05) == 7             # floor(8 * 0.95)
    assert trainer(mask=True, mask_ratio=0.75, token_drop=False)._static_len_keep(0.75) is None
    assert trainer(mask=True, random_mask_ratio=True)._static_len_keep(0.2) is None
    assert trainer()._static_len_keep(0.75) is None
    assert np.isfinite(t.train_one_epoch(1))
