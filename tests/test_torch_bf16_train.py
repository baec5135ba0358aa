"""The bf16 training slice (--use_fp16) against the JAX package's, on the
CPU: one Barlow Twins step of AudioNTT2022 (fused block 1, pool-reordered
block 2, LARS) and of a small ViT with --fused_attention (teacher masked by
key bias), each through the port's make_train_step, against the loss
function of ssl_audio_tpu.train (its Modules.apply_encoder casts the
encoder's parameters and input to bf16), jitted, from the same parameters
and the same two views.  Then a --use_fp16 run that stops and resumes bit
for bit, and the fp32 step left as it was.

Views: made here from a numpy seed and handed to both (the port's
augmentation is replaced by them; views made by two frameworks differ in
the last bits, which bf16 rounding would turn into noise of its own).
Dropout is the identity on both sides (flax's patched, the port's keep
mask of 0.7 scales back to exactly 1 in fp32 and in bf16).  The ViT's
token-mask noise is handed to both (tests/test_torch_vit.JaxDraws).

Tolerances (PERF.md section 2): the port's bf16 loss, gradients and new
running statistics are held against JAX's bf16 ones by JAX's own gap
between its bf16 and fp32 results on the same inputs: the port's relative
L2 gap at most GAP_FACTOR x JAX's, and under a fixed ceiling, LOSS_CEIL for
the loss and the statistics, GRAD_CEIL per gradient tensor.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.objectives.barlow import barlow_twins_loss as jax_barlow_twins_loss
from ssl_audio_tpu.train.state import Modules
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import _split_rngs, _view_rngs
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.state import encoder_forward, init_train_state
from ssl_audio_tpu_torch.train.steps import StepDraws, make_train_step
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests.test_torch_checkpoint import assert_tree_equal, run, small_cfg
from tests.test_torch_vit import JaxDraws

GAP_FACTOR = 2.0
LOSS_CEIL = 2e-2      # the loss and the running statistics, relative (L2)
# each gradient tensor, relative L2.  Above the 1e-1 one might expect: the
# Barlow Twins gradient of a batch of 4 moves by ~0.1 of a tensor's norm when
# its input moves in the seventh digit (tools/grad_sensitivity.py), so the
# bf16 roundings of every activation move it far more: JAX's own bf16 step is
# 0.08-0.29 from its fp32 step here, and the port, which rounds at other
# places (a linear layer's bias added before its rounding, not after; a
# two-pass LayerNorm), 0.04-0.26 from JAX's bf16 step (PERF.md section 2)
GRAD_CEIL = 0.35
FLOOR = 1e-5          # where JAX's bf16 and fp32 agree: fp32 noise of the step
B = 4
# conv biases before a BatchNorm: their gradient is 0 + float noise
ZERO_GRAD = ("encoder.features.0.bias", "encoder.features.4.bias", "encoder.norm.bias")
AUDIONTT = dict(dataset="synthetic", batch_size=B, crop_frames=32, projector_hidden_dim=256,
                fused_conv=True, pool_reorder=True, seed=0)
VIT = dict(dataset="synthetic", model_type="vit_tiny", batch_size=B, crop_frames=32,
           projector_hidden_dim=256, fused_attention=True, mask=True, mask_ratio=0.75,
           token_drop=False, wd=0.0, seed=0)
TOKENS = 8            # (64 / 16) x (32 / 16) patches


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold(port16, jax16, jax32, what, ceil):
    gap, jgap = rel_l2(port16, jax16), rel_l2(jax16, jax32)
    print(f"{what}: port vs JAX bf16 {gap:.2e}; JAX bf16 vs fp32 {jgap:.2e}")
    assert gap <= max(GAP_FACTOR * jgap, FLOOR), f"{what}: {gap:.2e} vs JAX's {jgap:.2e}"
    assert gap <= ceil, f"{what}: {gap:.2e} > {ceil}"
    return gap, jgap


def by_port_names(params, batch_stats, spec):
    """JAX parameter-shaped and batch-statistics trees -> the port's state
    dicts per module."""
    return train_state_dicts_from_jax(jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, batch_stats), vit_spec=spec)


def jax_loss_and_grads(mods, jstate, views, key, mask_ratio, spec=None):
    """The JAX step's loss function (train/steps.py loss_fn, teacher masked
    at mask_ratio) on the given views, jitted: (loss, gradients and the new
    running statistics, both as the port's state dicts).  spec: the port
    encoder's ViTSpec for a ViT."""
    ks = _split_rngs(key)
    bs = jstate.batch_stats

    def loss_fn(params):
        t_out, enc_bs = mods.apply_encoder(params["encoder"], bs["encoder"], views[0],
                                           train=True, rngs=_view_rngs(ks, 0),
                                           mask_ratio=mask_ratio)
        t_z, head_bs = mods.apply_head(params["head"], bs["head"], t_out, train=True)
        t_z, _ = mods.apply_predictor(params["predictor"], bs["predictor"], t_z, train=True)
        s_out, enc_bs = mods.apply_encoder(params["encoder"], enc_bs, views[1], train=True,
                                           rngs=_view_rngs(ks, 1))
        s_z, _ = mods.apply_head(params["head"], head_bs, s_out, train=True)
        loss = jax_barlow_twins_loss([s_z], [t_z], lmbda=mods.cfg.lmbda, alpha=mods.cfg.alpha,
                                     HSIC=mods.cfg.HSIC, world_scale=1.0)
        return loss, enc_bs

    (loss, enc_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    zero_stats = jax.tree.map(np.zeros_like, jstate.batch_stats)
    grads = by_port_names(grads, zero_stats, spec)
    stats = by_port_names(jstate.params, {**jstate.batch_stats, "encoder": enc_bs}, spec)
    return float(loss), grads, stats


def port_step(cfg, jstate, views, monkeypatch, draws, **step_kw):
    """The port's make_train_step on the given views, from JAX's weights ->
    (loss, gradients, the encoder's new running statistics, the state)."""
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    sds = by_port_names(jstate.params, jstate.batch_stats,
                        getattr(state.modules["encoder"], "spec", None))
    for name, module in state.modules.items():
        module.load_state_dict(sds[name], strict=True)
    pviews = [torch.from_numpy(np.array(v)) for v in views]
    monkeypatch.setattr(tsteps, "apply_pair_views", lambda *a: pviews)
    batch = torch.zeros(B, 1, cfg.n_mels, cfg.crop_frames)
    loss = float(make_train_step(cfg)(state, batch, draws=draws, **step_kw)["loss"])
    grads = {name: {k: p.grad for k, p in module.named_parameters() if p.grad is not None}
             for name, module in state.modules.items()}
    return loss, grads, state


def compare(port, j16, j32, zero_grad=ZERO_GRAD):
    """Loss, every gradient tensor and the encoder's running statistics."""
    (loss, grads, state), (jloss16, jg16, js16), (jloss32, jg32, js32) = port, j16, j32
    hold([loss], [jloss16], [jloss32], "loss", LOSS_CEIL)
    n = 0
    for name, named in grads.items():
        for k, g in named.items():
            if f"{name}.{k}" in zero_grad:
                continue
            assert g.dtype == torch.float32, k            # the fp32 masters' gradients
            if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                continue
            hold(g.numpy(), jg16[name][k], jg32[name][k], f"grad {name}.{k}", GRAD_CEIL)
            n += 1
    assert n >= 10
    for k, v in state.modules["encoder"].state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert v.dtype == torch.float32, k
            hold(v.numpy(), js16["encoder"][k], js32["encoder"][k], f"stat {k}", LOSS_CEIL)


def seeded_views(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((B, 1, cfg.n_mels, cfg.crop_frames))
                        .astype(np.float32)) for _ in range(2)]


def test_audiontt_fp16_step_matches_jax(monkeypatch, no_dropout):
    jcfg16 = jax_config(**AUDIONTT, use_fp16=True)
    mods16, jstate = jax_init_train_state(jcfg16, jax.random.key(0), niter_per_ep=2)
    mods32 = Modules(jax_config(**AUDIONTT))
    views, key = seeded_views(jcfg16), jax.random.key(100)
    j16 = jax_loss_and_grads(mods16, jstate, views, key, 0.0)
    j32 = jax_loss_and_grads(mods32, jstate, views, key, 0.0)
    cfg = default_config(**AUDIONTT, use_fp16=True, device="cpu")
    keep = [torch.full((B, cfg.crop_frames // 4, 2048), 0.7)] * 2    # 0.7 / (1 - 0.3) == 1
    port = port_step(cfg, jstate, views, monkeypatch,
                     StepDraws(starts=None, views=None, dropout=keep))
    compare(port, j16, j32)


def test_vit_fp16_fused_attention_step_matches_jax(monkeypatch):
    """vit_tiny at width 64, depth 2, 4 heads (both packages' size tables
    patched), --fused_attention: every block's attention through the fused
    functions, the JAX kernels in interpret mode, the port's plain versions
    in bf16; the teacher masked by key bias at 0.75."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})
    noise = np.random.default_rng(1).random((B, TOKENS)).astype(np.float32)
    jcfg16 = jax_config(**VIT, use_fp16=True)
    mods16, jstate = jax_init_train_state(jcfg16, jax.random.key(0), niter_per_ep=2)
    mods32 = Modules(jax_config(**VIT))
    views, key = seeded_views(jcfg16, seed=2), jax.random.key(101)
    monkeypatch.setattr(jvit, "jax", JaxDraws(noise=[noise, noise]))
    cfg = default_config(**VIT, use_fp16=True, device="cpu")
    spec = vit.get_mae_vit("tiny", cfg.patch_size, img_size=(64, 32)).spec
    j16 = jax_loss_and_grads(mods16, jstate, views, key, 0.75, spec)
    j32 = jax_loss_and_grads(mods32, jstate, views, key, 0.75, spec)
    draws = StepDraws(starts=None, views=None,
                      noise=[torch.from_numpy(noise), torch.from_numpy(noise)])
    port = port_step(cfg, jstate, views, monkeypatch, draws, mask_ratio=0.75)
    compare(port, j16, j32)


def test_fp16_step_uses_bf16_copies_of_fp32_masters():
    """encoder_forward: the fp32 step is the encoder itself; the bf16 one
    runs the encoder on bf16 parameters and input, returns fp32, leaves the
    masters and the running statistics fp32 and gives the masters fp32
    gradients through the cast."""
    for fp16 in (False, True):
        cfg = default_config(**AUDIONTT, use_fp16=fp16, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        enc = state.modules["encoder"].train()
        fwd = encoder_forward(cfg, enc)
        if not fp16:
            assert fwd is enc
            continue
        seen = []
        hook = enc.fc[0].register_forward_hook(
            lambda m, inp, out: seen.append((m.weight.dtype, inp[0].dtype, out.dtype)))
        out = fwd(torch.randn(B, 1, 64, 32), torch.ones(B, 8, 2048, dtype=torch.bool))
        hook.remove()
        assert out.dtype == torch.float32 and seen == [(torch.bfloat16,) * 3]
        out.sum().backward()
        assert all(p.dtype == torch.float32 for p in enc.parameters())
        assert enc.fc[0].weight.grad.dtype == torch.float32
        assert all(b.dtype == torch.float32 for k, b in enc.named_buffers()
                   if "running" in k)


def test_fp16_run_resumes_bit_for_bit(tmp_path):
    """A --use_fp16 run stopped after epoch 2 and resumed from model_2.pt
    ends where the uninterrupted run ends, bit for bit; the checkpoint holds
    the fp32 masters."""
    cfg = small_cfg("--dataset", "synthetic", "--use_fp16", epochs=3)
    full = run(cfg)
    run(cfg, ckpt_path=str(tmp_path), stop_at=3)
    ck = torch.load(tmp_path / "model_2.pt", map_location="cpu", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64) for v in ck["model"].values())
    resumed = run(cfg, ckpt_path=str(tmp_path), resume=str(tmp_path / "model_2.pt"))
    assert resumed.epoch_losses == {3: full.epoch_losses[3]}
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict(), "state")


def test_fp32_step_is_unchanged(monkeypatch):
    """The fp32 step still runs the encoder in fp32 (no cast on the path),
    and a step's loss with --use_fp16 differs from it at the bf16 level."""
    losses = {}
    for fp16 in (False, True):
        cfg = default_config(**AUDIONTT, use_fp16=fp16, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        seen = []
        state.modules["encoder"].fc[0].register_forward_hook(
            lambda m, inp, out: seen.append(out.dtype))
        views = [torch.from_numpy(np.array(v)) for v in seeded_views(cfg, seed=3)]
        monkeypatch.setattr(tsteps, "apply_pair_views", lambda *a: views)
        keep = [torch.full((B, 8, 2048), 0.7)] * 2
        losses[fp16] = float(make_train_step(cfg)(
            state, torch.zeros(B, 1, 64, 32),
            draws=StepDraws(starts=None, views=None, dropout=keep))["loss"])
        assert seen == [torch.bfloat16 if fp16 else torch.float32] * 2
    assert losses[True] != losses[False]
    np.testing.assert_allclose(losses[True], losses[False], rtol=LOSS_CEIL)
