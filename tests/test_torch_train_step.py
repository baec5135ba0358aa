"""The training slice as a whole: two consecutive Barlow Twins steps of the
port (ssl_audio_tpu_torch/train/steps.py) against the JAX package's
make_train_step (raw, jitted as its Trainer runs it), from the same
parameters, the same raw wav batches and the same random draws, on the CPU.

Randomness: JAX draws.  The test replays the key splits of the JAX step
(_split_rngs, make_pair_views, the frontend's randint) to recover the crop
starts and the augmentation parameters and injects them into the port's
step.  Dropout is taken out on both sides: flax.linen.Dropout is patched to
the identity and the port gets a keep mask that scales back to exactly 1.
Sizes are small (B = 4, 0.5-s clips, crop_frames 32, projector hidden 256)
at the full encoder width.  fp32 tolerance 1e-4 (BASELINE.md), relative to
each tensor's largest value, for the loss, the running statistics and the
mixup bank; the LARS momentum and the step each parameter took are held in
relative L2 to MOMENTUM_TOL, for the reason stated there."""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.data.pipeline import DataLoader as JaxDataLoader
from ssl_audio_tpu.train.loop import get_train_dataset as jax_get_train_dataset
from ssl_audio_tpu.objectives.barlow import barlow_twins_loss as jax_barlow_twins_loss
from ssl_audio_tpu.train.state import Modules
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import _split_rngs, _view_rngs
from ssl_audio_tpu.train.steps import init_monitor as jax_init_monitor
from ssl_audio_tpu.train.steps import make_device_frontend as jax_frontend
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu_torch.augment.transforms import apply_pair_views
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k
from ssl_audio_tpu_torch.train.loop import get_train_dataset
from ssl_audio_tpu_torch.objectives.barlow import barlow_twins_loss
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import (
    StepDraws,
    crop_start_bound,
    draw_step,
    init_monitor,
    make_device_frontend,
    make_train_step,
)
from ssl_audio_tpu_torch.utils.weights import lars_state_from_jax, train_state_dicts_from_jax
from tests.test_torch_augment import jax_pair_draws


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
# The step's ReLU and 2x2-pool decisions are discrete.  The port's views differ
# from JAX's in the last bits (VIEWS_ATOL: bicubic products, log-mixup-exp and
# the log-mel in other summation orders), an element that sits within that of a
# decision flips, and the flip reroutes one element's gradient while the forward
# barely moves: the gradients of the tensors before the decision (block weights,
# BatchNorm shifts) jump by ~1e-3 of their norm, the others by ~1e-5.  Measured
# here (relative L2 per tensor, worst over tensors, two steps): B = 4 2.3e-3 and
# 2.0e-3 (with predictor, HSIC, Gnoise), B = 8 8.6e-4 and 2.6e-3: a larger batch
# does not bring it under 1e-3, so B stays 4.  The bound leaves 4x over the
# worst reading.  test_fp32_gradient_noise_is_measured_against_fp64 shows with a
# float64 run of the JAX package that on the same views both packages agree
# within WITNESS_TOL, so the gap is the views' last bits and not the port.
MOMENTUM_TOL = 1e-2
# LARS moves a weight by ~2e-4 of its size per step, so fp32 rounding of the
# parameter itself is up to ~5e-4 of the step taken; added to MOMENTUM_TOL
DELTA_TOL = MOMENTUM_TOL + 1e-3
WITNESS_TOL = 1e-4         # fp32 against float64 on the same views (measured 2e-5..6e-5)
VIEWS_ATOL = 2e-5          # the port's views against JAX's, values up to ~3 (measured 8.6e-6)
ZERO_GRAD = ("features.0.bias", "features.4.bias")
ZERO_GRAD_ATOL = 1e-3      # conv biases before a batch norm: the gradient is 0 + float noise
B, L = 4, 8000
STATS = (-4.95, 5.855)
KW = dict(dataset="synthetic_wav", batch_size=B, crop_frames=32, projector_hidden_dim=256,
          mixup_n_memory=8, fused_conv=True, pool_reorder=True, seed=0)
FSD50K_KW = {**KW, "dataset": "fsd50k"}


def close(a, b, what, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a), b, atol=tol * scale, rtol=tol, err_msg=what)


def port_draws(key, cfg, hidden=2048) -> StepDraws:
    """The draws of the JAX step for `key`, as the port's StepDraws."""
    ks = _split_rngs(key)
    hi = crop_start_bound(cfg, L)
    starts = torch.from_numpy(np.array(jax.random.randint(ks["frontend"], (B,), 0, hi)))
    views = jax_pair_draws(ks["aug"], cfg, (B, 1, cfg.n_mels, cfg.crop_frames))
    keep = [torch.full((B, cfg.crop_frames // 4, hidden), 0.7)] * 2   # 0.7 / (1 - 0.3) == 1
    return StepDraws(starts=starts.to(torch.int32), views=views, dropout=keep)


_JAX_STATES = {}


def jax_initial_state(jcfg, niter_per_ep: int = 2):
    """(mods, jstate) of the JAX init_train_state for jcfg and key 0, made
    once per module (flax's eager init compiles op by op; the state is
    immutable, the tests share it)."""
    key = (repr(jcfg), niter_per_ep)
    if key not in _JAX_STATES:
        _JAX_STATES[key] = jax_init_train_state(jcfg, jax.random.key(0),
                                                niter_per_ep=niter_per_ep)
    return _JAX_STATES[key]


def jax_state_dicts(jstate):
    return train_state_dicts_from_jax(jax.tree.map(np.asarray, jstate.params),
                                      jax.tree.map(np.asarray, jstate.batch_stats))


def compare_states(state, jstate, before, jbefore):
    """`before`, `jbefore`: both packages' state dicts ahead of the step, for the
    step each parameter took."""
    want = jax_state_dicts(jstate)
    for name, module in state.modules.items():
        sd = module.state_dict()
        assert sd.keys() == want[name].keys()
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                close(v, want[name][k], f"{name}.{k}")
    mu = lars_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state.mu))
    for name, module in state.modules.items():
        for k, p in module.named_parameters():
            got = state.optimizer.state[p]["mu"]
            if k in ZERO_GRAD:
                assert float(got.abs().max()) < ZERO_GRAD_ATOL
                assert float(mu[name][k].abs().max()) < ZERO_GRAD_ATOL
                continue
            assert float((got - mu[name][k]).norm()) <= MOMENTUM_TOL * float(mu[name][k].norm()), \
                f"momentum {name}.{k}"
            took = p.detach().double() - before[name][k].double()
            jtook = want[name][k].double() - jbefore[name][k].double()
            assert float(jtook.norm()) > 0, f"{name}.{k} did not move"
            assert float((took - jtook).norm()) <= DELTA_TOL * float(jtook.norm()), \
                f"step taken by {name}.{k}"
    np.testing.assert_allclose(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank,
                               atol=TOL, err_msg="mixup bank")
    assert state.aug.mixup.count == int(jstate.aug.mixup.count)
    assert state.aug.mixup.pos == int(jstate.aug.mixup.pos)
    assert state.step == int(jstate.step) == state.optimizer.count


@pytest.mark.parametrize("options", [dict(), dict(predictor=True, HSIC=True, Gnoise=True)])
def test_two_train_steps_match_jax(monkeypatch, options):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    jcfg, cfg = jax_config(**KW, **options), default_config(**KW, **options, device="cpu")
    mods, jstate = jax_initial_state(jcfg)
    jstep = jax.jit(jax_make_train_step(mods, frontend=jax_frontend(jcfg, STATS), raw=True))

    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    sds = jax_state_dicts(jstate)
    for name, module in state.modules.items():
        module.load_state_dict(sds[name], strict=True)
    step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))

    rng = np.random.default_rng(0)
    jmon, mon = jax_init_monitor(), init_monitor("cpu")
    for i in range(2):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        key = jax.random.key(100 + i)
        before = {name: {k: v.clone() for k, v in module.state_dict().items()}
                  for name, module in state.modules.items()}
        jbefore = jax_state_dicts(jstate)
        jstate, jmetrics, jmon = jstep(jstate, jnp.asarray(wav), key, np.float32(0.0), jmon)
        metrics, mon = step(state, torch.from_numpy(wav), draws=port_draws(key, cfg),
                            monitor=mon)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=TOL, err_msg=f"loss of step {i}")
        compare_states(state, jstate, before, jbefore)
    assert bool(mon["finite"]) and int(mon["count"]) == int(jmon["count"]) == 2
    np.testing.assert_allclose(float(mon["loss_sum"]), float(jmon["loss_sum"]), rtol=TOL)


def test_one_fsd50k_epoch_matches_jax(tmp_path, monkeypatch):
    """The on-disk slice as a whole: an epoch over a tiny FSD50K tree (dev.csv
    with 4 train and 4 val rows, log-mels of 30-900 frames), each package's
    get_train_dataset and loader (the C++ reader; bit-identical batches),
    each package's step from the same parameters and draws (JAX's keys,
    dropout out on both sides): the per-step losses and the epoch's mean
    within TOL relative."""
    from tests.test_torch_native_loader import load_jax_readers

    load_jax_readers()
    fabricate_fsd50k(str(tmp_path / "data"), 4, (30, 900), seed=3, n_val=4, n_classes=5,
                     max_labels=2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    jcfg, cfg = jax_config(**FSD50K_KW), default_config(**FSD50K_KW, device="cpu")
    jloader = JaxDataLoader(jax_get_train_dataset(jcfg), 4, num_workers=2, seed=0)
    loader = DataLoader(get_train_dataset(cfg), 4, num_workers=2, seed=0,
                        log=lambda line: None)
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=len(loader))
    jstep = jax.jit(jax_make_train_step(mods, raw=True))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=len(loader),
                             device="cpu")
    sds = jax_state_dicts(jstate)
    for name, module in state.modules.items():
        module.load_state_dict(sds[name], strict=True)
    step = make_train_step(cfg)
    jmon, mon = jax_init_monitor(), init_monitor("cpu")
    batches = list(zip(loader, jloader))
    assert len(batches) == 2
    for i, ((x, _), (jx, _)) in enumerate(batches):
        assert np.array_equal(x, jx)
        key = jax.random.key(200 + i)
        jstate, jmetrics, jmon = jstep(jstate, jnp.asarray(jx), key, np.float32(0.0), jmon)
        metrics, mon = step(state, torch.from_numpy(x), draws=port_draws(key, cfg),
                            monitor=mon)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=TOL, err_msg=f"loss of step {i}")
    np.testing.assert_allclose(float(mon["loss_sum"]) / int(mon["count"]),
                               float(jmon["loss_sum"]) / int(jmon["count"]), rtol=TOL)


def jax_loss_and_grads(mods, jcfg, jstate, views, ks, dtype):
    """The JAX step's loss function (train/steps.py loss_fn, masking off) and
    its gradients in `dtype`, jitted as the JAX step is, on views the caller
    made: the test's witness when dtype is float64 (under jax.enable_x64)."""
    def cast(tree):
        return jax.tree.map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)

    vs, bs = [v.astype(dtype) for v in views], cast(jstate.batch_stats)

    def loss_fn(params):
        t_out, enc_bs = mods.apply_encoder(params["encoder"], bs["encoder"], vs[0], train=True,
                                           rngs=_view_rngs(ks, 0), mask_ratio=0.0)
        t_z, head_bs = mods.apply_head(params["head"], bs["head"], t_out, train=True)
        t_z, _ = mods.apply_predictor(params["predictor"], bs["predictor"], t_z, train=True)
        s_out, _ = mods.apply_encoder(params["encoder"], enc_bs, vs[1], train=True,
                                      rngs=_view_rngs(ks, 1))
        s_z, _ = mods.apply_head(params["head"], head_bs, s_out, train=True)
        return jax_barlow_twins_loss([s_z], [t_z], lmbda=jcfg.lmbda, alpha=jcfg.alpha,
                                     HSIC=jcfg.HSIC, world_scale=1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(cast(jstate.params))
    assert loss.dtype == dtype
    return float(loss), lars_state_from_jax(jax.tree.map(np.asarray, grads))


def worst_rel_l2(grads, witness):
    """Largest |g - w| / |w| (L2) over the parameter tensors; grads: module name
    -> iterable of (parameter name, tensor)."""
    worst = 0.0
    for name, named in grads.items():
        for k, g in named:
            if k in ZERO_GRAD:
                continue
            w = witness[name][k].double()
            worst = max(worst, float((g.double() - w).norm() / w.norm()))
    return worst


@pytest.mark.parametrize("options", [dict(), dict(predictor=True, HSIC=True, Gnoise=True)])
def test_fp32_gradient_noise_is_measured_against_fp64(monkeypatch, options):
    """Where MOMENTUM_TOL comes from, with a witness that owes nothing to the
    port: the JAX package's own loss function in float64 (the unfused block,
    which is the same function: the Pallas kernel is fp32 only) on the views
    the JAX step made in fp32.  Against its gradients, per tensor in relative
    L2:
      - the JAX fp32 step's gradients (fused block, interpret mode) and the
        port's forward and backward in fp32 on those same views both stay
        within WITNESS_TOL: the two packages compute the same function;
      - the port's whole step, whose views differ from JAX's in the last bits
        (asserted: VIEWS_ATOL), is off by up to MOMENTUM_TOL, and only in the
        tensors whose gradient a flipped ReLU or pool decision reroutes.
    Run with -s to see the numbers."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    jcfg, cfg = jax_config(**KW, **options), default_config(**KW, **options, device="cpu")
    mods, jstate = jax_initial_state(jcfg)
    unfused = Modules(jax_config(**{**KW, **options, "fused_conv": False,
                                    "pool_reorder": False}))
    wav = (0.3 * np.random.default_rng(0).standard_normal((B, L))).astype(np.float32)
    key = jax.random.key(100)
    ks = _split_rngs(key)
    jviews, _ = mods.make_views(ks["aug"],
                                jax_frontend(jcfg, STATS)(ks["frontend"], jnp.asarray(wav)),
                                jstate.aug)
    with jax.enable_x64(True):
        loss64, witness = jax_loss_and_grads(unfused, jcfg, jstate, jviews, ks, jnp.float64)
    loss_jax, grads_jax = jax_loss_and_grads(mods, jcfg, jstate, jviews, ks, jnp.float32)

    def port_state():
        state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                                 device="cpu")
        sds = jax_state_dicts(jstate)
        for name, module in state.modules.items():
            module.load_state_dict(sds[name], strict=True)
        return state

    def named_grads(state):
        return {name: [(k, p.grad) for k, p in module.named_parameters()]
                for name, module in state.modules.items()}

    # the port's modules on JAX's views
    on_jax_views = port_state()
    m = on_jax_views.modules.train()
    keep = torch.full((B, cfg.crop_frames // 4, 2048), 0.7)
    zs = [m["head"](m["encoder"](torch.from_numpy(np.array(v)), keep)) for v in jviews]
    loss_port = barlow_twins_loss(zs[1:], [m["predictor"](zs[0])], lmbda=cfg.lmbda,
                                  alpha=cfg.alpha, HSIC=cfg.HSIC)
    loss_port.backward()
    # the port's whole step: its own frontend and views from the same draws
    whole = port_state()
    draws = port_draws(key, cfg)
    frontend = make_device_frontend(cfg, STATS)
    pviews = apply_pair_views(frontend(torch.from_numpy(wav), draws.starts),
                              port_state().aug, cfg, draws.views)
    views_err = max(float((a - torch.from_numpy(np.array(b))).abs().max())
                    for a, b in zip(pviews, jviews))
    make_train_step(cfg, frontend=frontend)(whole, torch.from_numpy(wav), draws=draws)

    as_named = {name: list(g.items()) for name, g in grads_jax.items()}
    err_jax = worst_rel_l2(as_named, witness)
    err_port = worst_rel_l2(named_grads(on_jax_views), witness)
    err_step = worst_rel_l2(named_grads(whole), witness)
    print(f"gradients against the float64 witness, worst relative L2 per tensor: JAX fp32 "
          f"{err_jax:.2e}, port fp32 on the same views {err_port:.2e}, port's whole step "
          f"{err_step:.2e} (its views differ by {views_err:.1e})")
    np.testing.assert_allclose(loss_jax, loss64, rtol=1e-6)
    np.testing.assert_allclose(float(loss_port.detach()), loss64, rtol=1e-6)
    assert err_jax <= WITNESS_TOL
    assert err_port <= WITNESS_TOL
    assert views_err <= VIEWS_ATOL
    assert err_step <= MOMENTUM_TOL


def test_step_draws_from_its_generator_and_moves_everything():
    """Without injected draws the step draws from the generator: the same
    seed gives the same losses, every parameter and running statistic moves,
    and the monitor flags a non-finite loss."""
    cfg = default_config(**KW, device="cpu")
    step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    wav = torch.from_numpy(
        (0.3 * np.random.default_rng(1).standard_normal((B, L))).astype(np.float32))
    losses = []
    for _ in range(2):
        state = init_train_state(cfg, torch.Generator().manual_seed(3), niter_per_ep=2,
                                 device="cpu")
        before = {k: v.clone() for k, v in state.modules.state_dict().items()}
        gen = torch.Generator().manual_seed(5)
        losses.append([float(step(state, wav, gen=gen)["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))
    for k, v in state.modules.state_dict().items():
        if k.endswith("bias") and ("features.0" in k or "features.4" in k):
            continue                      # conv bias before a batch norm: zero gradient
        assert not torch.equal(v, before[k]), k
    d = draw_step(torch.Generator().manual_seed(0), cfg, (B, L), state.modules["encoder"],
                  wav=True)
    assert d.starts.dtype == torch.int32 and int(d.starts.max()) <= 51 - 32
    assert d.dropout[0].shape == (B, 8, 2048) and 0.6 < float(d.dropout[0].float().mean()) < 0.8
    mon = init_monitor("cpu")
    _, mon = step(state, torch.full_like(wav, float("nan")), gen=gen, monitor=mon)
    assert not bool(mon["finite"])


def test_backward_runs_with_cudnn_tf32_off():
    """cuDNN reads its TF32 flag when a kernel runs, so the step keeps
    loss.backward(), not only the forward, inside ops.no_tf32(): a hook that
    fires during backward sees the flag off, and it is restored afterwards."""
    cfg = default_config(**KW, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    seen = []
    state.modules["encoder"].features[4].weight.register_hook(
        lambda grad: seen.append(torch.backends.cudnn.allow_tf32))
    before = torch.backends.cudnn.allow_tf32
    wav = torch.from_numpy(
        (0.3 * np.random.default_rng(2).standard_normal((B, L))).astype(np.float32))
    make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))(
        state, wav, gen=torch.Generator().manual_seed(1))
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 == before


def test_deferred_flags_raise():
    from ssl_audio_tpu_torch.config import require_supported, unsupported_settings

    assert unsupported_settings(default_config(dataset="synthetic_wav")) == []
    for kw in (dict(model_type="vit_base", fused_attention=True), dict(masked_recon=True),
               dict(model_type="vitc_small", mask=True, mask_ratio=0.75),
               dict(resume_path="x"), dict(save_base_dir="x"),
               dict(dataset="synthetic_multicue"), dict(dataset="fsd50k"),
               dict(dataset="fsd50k", load_lms=False), dict(dataset="audioset_wav"),
               dict(dataset="audioset+librispeech"), dict(dataset="nsynth"),
               dict(use_fp16=True), dict(use_fp16_eval=True), dict(steps_per_dispatch=4),
               dict(profile_dir="x"), dict(squeeze_excitation=True),
               dict(model_type="resnet18"), dict(model_type="resnet50_ReGP_NRF"),
               dict(model_type="vit_base", remat=True), dict(distributed=True),
               dict(data_axis_size=1), dict(dataset="cifar10", model_type="vit_tiny"),
               dict(dataset="cifar10", model_type="vit_tiny", distributed=True)):
        assert unsupported_settings(default_config(**{"dataset": "synthetic_wav", **kw})) == []
    for kw in (dict(data_axis_size=3),
               dict(model_type="vitc_base", layout_barrier=True),
               dict(dataset="cifar10", model_type="vit_tiny", distributed=True, fsdp=True),
               dict(distributed=True, fsdp=True),
               dict(model_type="vit_tiny", layout_barrier=True),
               dict(model_type="vit_base", layout_barrier=True), dict(fsdp=True),
               dict(model_parallel=2)):
        cfg = default_config(**{"dataset": "synthetic_wav", **kw})
        with pytest.raises(NotImplementedError):
            require_supported(cfg)
    # the JAX package builds CIFAR-10's encoder from the ViT family only
    with pytest.raises(ValueError):
        require_supported(default_config(dataset="cifar10"))
    assert callable(make_train_step(default_config(dataset="synthetic", use_fp16=True)))
    # the BYOL variant is ported: its state holds a target equal to the online net
    byol = init_train_state(default_config(dataset="synthetic", projector_hidden_dim=64),
                            torch.Generator(), byol=True, device="cpu")
    online = {k: v for k, v in byol.modules.state_dict().items() if not k.startswith("target.")}
    assert {f"target.{k}" for k in online} == set(byol.modules.state_dict()) - set(online)
    assert all(torch.equal(byol.modules.state_dict()[f"target.{k}"], v)
               for k, v in online.items())
    if not torch.cuda.is_available():       # device None = the card, never the CPU
        with pytest.raises(RuntimeError):
            init_train_state(default_config(dataset="synthetic"), torch.Generator())


def test_launch_counters_count_kernels_only():
    """ops.launch_counts() names every kernel instantiation; the CPU path runs
    the plain versions and launches nothing, so a CPU step leaves them at 0."""
    from ssl_audio_tpu_torch.ops import launch_counts, zero_launch_counts
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    log_mel_cuda.launches["folded"] += 3
    zero_launch_counts()
    cfg = default_config(**KW, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    wav = torch.from_numpy(
        (0.3 * np.random.default_rng(4).standard_normal((B, L))).astype(np.float32))
    make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))(
        state, wav, gen=torch.Generator().manual_seed(1))
    kernels = ("fused_conv1_fwd", "fused_conv1_bwd", "fused_conv1_dx", "fused_attention_fwd",
               "fused_attention_bwd")
    assert launch_counts() == {"log_mel_folded": 0, "log_mel_unfolded": 0,
                               **{k: 0 for k in kernels},
                               **{f"{k}_bf16": 0 for k in kernels}}
