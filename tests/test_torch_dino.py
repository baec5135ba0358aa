"""The legacy DINO family of the port (ssl_audio_tpu_torch/objectives/dino.py,
train/legacy_steps.py make_dino_train_step, train/optim.py
make_legacy_optimizer, utils/schedules.py cosine_scheduler, config.py's
method recipes, utils/weights.py legacy_state_dicts_from_jax) against the
JAX package's, on the CPU at small sizes.

Steps: the JAX step jitted with its views as an extra output; the port's
own views are held against JAX's within VIEWS_RTOL and the port's step then
runs on JAX's views (tests/test_torch_byol.py says why).  AudioNTT2022's
dropout is on: the JAX step hands one rngs dict to every encoder forward,
so one keep mask serves all of them; the mask is read off an eager apply
with that dict (recorded_dropout) and handed to the port's step, which
draws one set for the step (draw_legacy_step).

Tolerances: TOL (1e-4, relative to each tensor's largest value) for the
loss, the parameters of both stacks, the centre and the running statistics;
AdamW's moments per tensor in relative L2 to MOMENT_TOL, where the
gradient is not float noise (ZERO_GRAD, see there); each parameter's
change over the steps, of both stacks, against JAX's change in relative L2
to DELTA_TOL (the update half of a step: lr, weight decay, the EMA), where
the absolute TOL could not see it.  The numpy schedules' arrays bit for
bit, the fp32 factor of the optimizer to one ulp (see there)."""
import contextlib
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.objectives import dino as jdino
from ssl_audio_tpu.train import legacy_steps as jlegacy
from ssl_audio_tpu.train.optim import legacy_cosine_factor as jax_legacy_cosine_factor
from ssl_audio_tpu.utils.schedules import cosine_scheduler as jax_cosine_scheduler
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.objectives import dino
from ssl_audio_tpu_torch.train import legacy_steps
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.optim import legacy_cosine_factor
from ssl_audio_tpu_torch.train.state import build_encoder
from ssl_audio_tpu_torch.train.steps import StepDraws
from ssl_audio_tpu_torch.utils.schedules import cosine_scheduler
from ssl_audio_tpu_torch.utils.weights import (
    _zero_stats_like,
    dino_head_state_dict_from_jax,
    legacy_state_dicts_from_jax,
)
from tests.test_torch_augment import jax_pair_draws
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4
# the port's views against JAX's, relative to the largest value (the same
# bicubic crops and mixup in another order of fp32 work; measured 5e-6 on
# N(0, 1) batches, tests/test_torch_train_step.py VIEWS_ATOL on log-mels)
VIEWS_RTOL = 1e-5
# AdamW's first and second moments per tensor, relative L2: fp32 noise of
# the gradient through four (ViT: six) encoder forwards and the sharpened
# teacher softmax (measured up to 1.8e-5 for AudioNTT2022, 1.9e-5 for
# vit_tiny, two DINO steps; 2.0e-4 for two BYOL-A steps, block 1's weight)
MOMENT_TOL = 5e-4
# biases before a BatchNorm, which removes any constant shift: AudioNTT2022's
# convs', the BYOL-A heads' first Linear's, and the projector's last (the
# predictor's BatchNorm follows it).  Their gradient is 0 + float noise, its
# moments within ZERO_GRAD_ATOL of 0 (squared for the second), an encoder's
# within ZERO_GRAD_STEPS x lr of 0 a step on both sides
ZERO_GRAD = ("encoder.features.0.bias", "encoder.features.4.bias", "head.net.0.bias",
             "head.net.3.bias", "predictor.net.0.bias")
ZERO_GRAD_ATOL = 1e-4
ZERO_GRAD_STEPS = 1.5
# each parameter's change over two steps (p - p0, target - target0) against
# JAX's, relative L2 beyond one ulp of each element of the result (a change
# of ~1e-6 on a weight of 1 is a few ulps), leaving out the OUTLIERS share
# of a tensor's elements that differ most: where Adam's first moment nearly
# cancels in the second step its ~lr step takes an arbitrary sign (20 of
# BYOL-A's 2,048 fc.3 biases; 9e-2 relative L2 with them).  Measured up to
# 5.0e-5 without them over two steps, 2.5e-4 over twenty at lr 1e-3
DELTA_TOL = 1e-3
OUTLIERS = 0.02
# the same optimizer's change of a parameter on the same gradients, relative
# L2 (fp32 rounding; measured up to 8.3e-6)
OPT_TOL = 1e-4
# twenty DINO steps at lr 1e-3: each step's loss against JAX's, relative
# (measured up to 4.1e-5)
LONG_LOSS_RTOL = 5e-4
B = 4
# wd -> final_wd far above the recipe's 0.04 -> 0.4, so that the decoupled
# decay (lr * wd * p a step, against Adam's ~lr) and its cosine show in
# DELTA_TOL; BYOL-A's Adam has none
KW = dict(dataset="synthetic", batch_size=B, crop_frames=32, dino_out_dim=32,
          mixup_n_memory=8, warmup_epochs=0, epochs=1, fused_conv=True, pool_reorder=True,
          seed=0, wd=1.0, final_wd=3.0)
VIT_KW = dict(KW, model_type="vit_tiny", local_crops_number=2)
NITER = 2             # iterations an epoch: the schedules' length


def close(a, b, what, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a), b, atol=tol * scale, rtol=tol, err_msg=what)


def rel_l2(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(np.asarray(b)).double()
    return float((a - b).norm() / b.norm())


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def lms(seed: int, shape=(B, 1, 64, 32)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@contextlib.contextmanager
def recorded_dropout():
    """flax's Dropout as it is, each train-mode call's keep mask appended
    to the yielded list (the rng it draws is the one flax would draw)."""
    seen = []
    orig = flax.linen.Dropout.__call__

    def call(self, inputs, deterministic=None, rng=None):
        det = flax.linen.module.merge_param("deterministic", self.deterministic,
                                            deterministic)
        if not det and self.rate > 0:
            rng = self.make_rng(self.rng_collection)
            seen.append(jax.random.bernoulli(rng, 1.0 - self.rate, inputs.shape))
        return orig(self, inputs, deterministic, rng)

    flax.linen.Dropout.__call__ = call
    try:
        yield seen
    finally:
        flax.linen.Dropout.__call__ = orig


_KEEP_MASKS = {}


def jax_keep_masks(mods, jstate, key, x) -> list:
    """The dropout keep masks of an encoder apply (jitted once per mods)
    with the step's rngs dict (k_enc of split(key), as the JAX step makes
    it)."""
    def masks(params, bs, x, key):
        _, k_enc = jax.random.split(key)
        with recorded_dropout() as seen:
            mods.encoder_fwd(params, bs, x, {"mask": k_enc, "dropout": k_enc,
                                             "droppath": k_enc})
        return seen

    jitted = _KEEP_MASKS.setdefault(id(mods), jax.jit(masks))
    return [np.array(m) for m in jitted(jstate.params["encoder"], jstate.batch_stats["encoder"],
                                        jnp.asarray(x), key)]


class JaxLegacy:
    """A JAX legacy step (make_dino_train_step / make_byola_train_step)
    jitted with its views as an extra output, and the port's views replaced
    by them once the port's own were held against them.
    step(jstate, batch, key, *scalars) -> (jstate, metrics)."""

    def __init__(self, mods, jstep, monkeypatch):
        self.views, self.gaps = None, []
        raw = jstep.__wrapped__

        def step_and_views(jstate, batch, key, *scalars):
            seen = []
            make_views = mods.make_views
            mods.make_views = lambda *a: seen.append(make_views(*a)) or seen[0]
            try:
                jstate, metrics = raw(jstate, batch, key, *scalars)
            finally:
                mods.make_views = make_views
            return jstate, metrics, seen[0][0]

        self.jitted = jax.jit(step_and_views)
        apply_pair_views = tsteps.apply_pair_views

        def replay(batch, aug, cfg, draws):
            ours = apply_pair_views(batch, aug, cfg, draws)
            theirs = [torch.from_numpy(v) for v in self.views]
            self.gaps.append(max(float((a - b).abs().max() / b.abs().max())
                                 for a, b in zip(ours, theirs)))
            return theirs

        monkeypatch.setattr(tsteps, "apply_pair_views", replay)

    def step(self, jstate, batch, key, *scalars):
        jstate, metrics, views = self.jitted(jstate, jnp.asarray(batch), key,
                                             *[np.float32(s) for s in scalars])
        self.views = [np.array(v) for v in views]
        return jstate, metrics


def port_views(key, cfg, shape):
    """The views' draws of the JAX step for `key` (make_pair_views(k_aug))."""
    k_aug, _ = jax.random.split(key)
    return jax_pair_draws(k_aug, cfg, shape)


def vit_spec(state):
    enc = state.modules["encoder"]
    return enc.spec if hasattr(enc, "spec") else None


def load_from_jax(state, jstate, method: str) -> None:
    """Both stacks (and the DINO centre) of a JAX legacy state into the
    port's state."""
    spec = vit_spec(state)
    online = legacy_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats),
                                         method, spec)
    target = legacy_state_dicts_from_jax(as_np(jstate.target_params),
                                         as_np(jstate.target_batch_stats), method, spec)
    for name, sd in online.items():
        state.modules[name].load_state_dict(sd, strict=True)
        state.modules["target"][name].load_state_dict(target[name], strict=True)
    if state.center is not None:
        state.center.copy_(torch.from_numpy(np.array(jstate.extra["center"])))


def adam_moments(opt_state):
    """(mu, nu) trees out of the JAX optimizer state."""
    found = []

    def visit(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append((x.mu, x.nu))
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif hasattr(x, "inner_state"):
            visit(x.inner_state)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


def peak_lr(cfg) -> float:
    """The largest lr of the legacy recipes: DINO's base_lr * B / 256 (its
    cosine only falls from there), BYOL-A's constant base_lr."""
    return cfg.base_lr * (cfg.batch_size / 256 if cfg.optimizer == "AdamW" else 1.0)


def compare_changes(state, jstate, start, method: str) -> None:
    """Each parameter's change from `start` (the JAX state both began at),
    of the online stack and of the target, against JAX's change."""
    spec = vit_spec(state)
    stacks = {}
    for which, s in (("end", jstate), ("start", start)):
        stacks[which] = (
            legacy_state_dicts_from_jax(as_np(s.params), as_np(s.batch_stats), method, spec),
            legacy_state_dicts_from_jax(as_np(s.target_params), as_np(s.target_batch_stats),
                                        method, spec))
    n = 0
    for name in stacks["end"][0]:
        for i, module in enumerate((state.modules[name], state.modules["target"][name])):
            end, start_ = stacks["end"][i][name], stacks["start"][i][name]
            for k, p in module.named_parameters():
                if f"{name}.{k}" in ZERO_GRAD:
                    continue
                p0 = torch.from_numpy(np.array(start_[k])).double()
                got = p.detach().double() - p0
                want = torch.from_numpy(np.array(end[k])).double() - p0
                what = f"change of {('online', 'target')[i]} {name}.{k}"
                if not want.any():                # the frozen g of the DINO head
                    assert not got.any(), what
                    continue
                err = (got - want).abs().flatten()
                kept = err.argsort()[:err.numel() - int(OUTLIERS * err.numel())]
                ulps = np.linalg.norm(np.spacing(np.abs(np.array(end[k]))).ravel()[kept.numpy()])
                gap = (float(err[kept].norm()) - ulps) / float(want.flatten()[kept].norm())
                assert gap <= DELTA_TOL, f"{what}: {gap}"
                n += 1
    assert n >= 20


def compare(state, jstate, method: str, start) -> None:
    """Every parameter and running statistic of both stacks, the centre,
    the optimizer's moments, and each parameter's change from `start`."""
    compare_changes(state, jstate, start, method)
    spec = vit_spec(state)
    want = legacy_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats),
                                       method, spec)
    want_t = legacy_state_dicts_from_jax(as_np(jstate.target_params),
                                         as_np(jstate.target_batch_stats), method, spec)
    for name in want:
        for stack, ref, module in (("online", want[name], state.modules[name]),
                                   ("target", want_t[name], state.modules["target"][name])):
            sd = module.state_dict()
            assert sd.keys() == ref.keys(), f"{stack} {name}"
            for k, v in sd.items():
                if f"{name}.{k}" in ZERO_GRAD and name == "encoder":
                    # Adam moves a parameter whose gradient is float noise by
                    # about lr a step, its sign the noise's: both stay within
                    # it of their start, 0
                    bound = ZERO_GRAD_STEPS * state.step * peak_lr(state.cfg)
                    got, want_k = float(v.abs().max()), float(np.abs(np.asarray(ref[k])).max())
                    assert max(got, want_k) < bound, f"{stack} {name}.{k}"
                elif not k.endswith("num_batches_tracked"):
                    close(v, ref[k], f"{stack} {name}.{k}")
    if state.center is not None:
        close(state.center, jstate.extra["center"], "center")
    zeros = _zero_stats_like(as_np(jstate.params))
    mu, nu = (legacy_state_dicts_from_jax(as_np(t), zeros, method, spec)
              for t in adam_moments(jstate.opt_state))
    for name in want:
        for k, p in state.modules[name].named_parameters():
            if not p.requires_grad:           # the frozen g of the DINO head
                assert not np.asarray(mu[name][k]).any()
                continue
            st = state.optimizer.state[p]
            for got, ref, what in ((st["exp_avg"], mu[name][k], "mu"),
                                   (st["exp_avg_sq"], nu[name][k], "nu")):
                if f"{name}.{k}" in ZERO_GRAD:
                    assert float(got.abs().max()) < ZERO_GRAD_ATOL ** (1 + (what == "nu"))
                    continue
                assert rel_l2(got, ref) <= MOMENT_TOL, f"{what} {name}.{k}: {rel_l2(got, ref)}"


_JAX_STATES = {}


def jax_state(kw, method: str, niter: int = NITER):
    """(mods, jstate) of JAX's init_legacy_state for kw, made once per
    module (flax's eager init compiles op by op; the state is immutable)."""
    key = (method, niter, tuple(sorted(kw.items())))
    if key not in _JAX_STATES:
        _JAX_STATES[key] = jlegacy.init_legacy_state(
            jax_config(method=method, **kw), jax.random.key(0), method, niter_per_ep=niter)
    return _JAX_STATES[key]


def make_pair(kw, method: str, monkeypatch, niter: int = NITER):
    """(jcfg, mods, jstate, jstep wrapper, cfg, port state) from one state."""
    jcfg = jax_config(method=method, **kw)
    mods, jstate = jax_state(kw, method, niter)
    factory = jlegacy.make_dino_train_step if method == "dino" else jlegacy.make_byola_train_step
    jax_step = JaxLegacy(mods, factory(mods), monkeypatch)
    cfg = default_config(method=method, device="cpu", **kw)
    state = legacy_steps.init_legacy_state(cfg, torch.Generator().manual_seed(0), method,
                                           niter_per_ep=niter, device="cpu")
    load_from_jax(state, jstate, method)
    return jcfg, mods, jstate, jax_step, cfg, state


# --- schedules and recipes ------------------------------------------------------

@pytest.mark.parametrize("base,final,epochs,niter,warmup", [
    (5e-4, 1e-6, 40, 97, 6),       # the DINO recipe's lr
    (0.04, 0.4, 40, 97, 0),        # its weight decay (rising)
    (0.996, 1.0, 10, 13, 0),       # the teacher momentum
    (1.0, 0.1, 3, 1, 2),           # two warm-up iterations
    (1.0, 0.1, 2, 1, 1),           # one (np.linspace with num=1)
])
def test_schedules_equal_jax_bit_for_bit(base, final, epochs, niter, warmup):
    ref = jax_cosine_scheduler(base, final, epochs, niter, warmup_epochs=warmup)
    got = cosine_scheduler(base, final, epochs, niter, warmup_epochs=warmup)
    np.testing.assert_array_equal(got, ref)
    jfn = jax_legacy_cosine_factor(base, final, epochs, niter, warmup_epochs=warmup)
    steps = np.arange(len(ref) + 3)          # three past the budget: clamped
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps)))
    fn = legacy_cosine_factor(base, final, epochs, niter, warmup_epochs=warmup)
    got = np.array([fn(int(s)) for s in steps], np.float32)
    # the same fp32 arithmetic, but for the cosine: XLA's fp32 cos is a
    # polynomial of its own, the port rounds the exact one; at a few steps
    # (17 of 3,883 in the first case) the two round to neighbours, one cos
    # ulp (<= 2^-23) times the half range, plus the result's own rounding
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=abs(base - final) * 2.0 ** -23 + np.spacing(want).max())
    assert (got != want).mean() < 0.01
    temps = (jdino.teacher_temp_schedule(0.04, 0.4, min(18, epochs), epochs),
             dino.teacher_temp_schedule(0.04, 0.4, min(18, epochs), epochs))
    np.testing.assert_array_equal(temps[1], temps[0])


def test_method_recipes_are_the_jax_configs():
    for method in ("dino", "byola", None):
        for model in ("audiontt", "vit_base"):
            for extra in ({}, {"base_lr": 1e-3, "wd": 0.1, "final_wd": 0.2}):
                want = jax_config(method=method, model_type=model, **extra)
                got = default_config(method=method, model_type=model, **extra)
                for k in ("optimizer", "base_lr", "wd", "final_wd", "lr", "lr_weights",
                          "lr_biases", "dino_out_dim", "teacher_temp", "momentum_teacher"):
                    assert getattr(got, k) == getattr(want, k), (method, model, extra, k)


@pytest.mark.parametrize("method", ["dino", "byola"])
def test_legacy_optimizer_recipe(method):
    """DINO: AdamW, lr 0 at step 0 of the warm-up, the weight decay on ndim
    > 1 parameters only and on its cosine; BYOL-A: Adam at base_lr."""
    from ssl_audio_tpu_torch.train.optim import make_legacy_optimizer

    cfg = default_config(method=method, epochs=3, batch_size=512)
    params = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.ones(3))]
    opt, sched = make_legacy_optimizer(cfg, method, params, niter_per_ep=4)
    if method == "byola":
        assert type(opt) is torch.optim.Adam and sched is None
        assert opt.param_groups[0]["lr"] == 3e-4
        return
    assert type(opt) is torch.optim.AdamW
    decayed, plain = opt.param_groups
    assert decayed["params"][0] is params[0] and plain["params"][0] is params[1]
    assert decayed["lr"] == 0.0 and decayed["weight_decay"] == pytest.approx(0.04)
    assert plain["weight_decay"] == 0.0
    wd = cosine_scheduler(0.04, 0.4, 3, 4)
    lr = cosine_scheduler(5e-4 * 512 / 256, 1e-6, 3, 4, warmup_epochs=6)
    for i in range(1, 4):
        sched.step()
        assert decayed["lr"] == pytest.approx(lr[i], rel=1e-6)
        assert decayed["weight_decay"] == pytest.approx(wd[i], rel=1e-6)
        assert plain["weight_decay"] == 0.0


@pytest.mark.parametrize("method", ["dino", "byola"])
def test_legacy_optimizer_updates_match_jax(method):
    """The same gradients through JAX's legacy optimizer (optax's AdamW with
    its lr and weight-decay schedules and the ndim > 1 mask; Adam) and the
    port's, step by step: the warm-up from lr 0, both cosines, the decay on
    the 4-d and 2-d parameters only, a step past the budget.  Each step's
    parameters are held by their change from the start, in relative L2."""
    import optax

    from ssl_audio_tpu.train.optim import make_legacy_optimizer as jax_make_legacy_optimizer
    from ssl_audio_tpu_torch.train.optim import make_legacy_optimizer

    kw = dict(epochs=2, batch_size=64, base_lr=0.2, final_lr=1e-3, warmup_epochs=1, wd=0.5,
              final_wd=2.0)
    niter = 3
    rng = np.random.default_rng(11)
    shapes = {"conv": (4, 3, 3, 3), "dense": (8, 6), "bias": (6,), "scale": (6,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_make_legacy_optimizer(jax_config(method=method, **kw), method, niter)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = make_legacy_optimizer(default_config(method=method, **kw), method,
                                       list(params.values()), niter)
    for i in range(2 * niter + 1):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = update({k: jnp.asarray(g) for k, g in grads.items()}, opt_state,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in grads.items():
            params[k].grad = torch.from_numpy(g)
        opt.step()
        if sched is not None:
            sched.step()
        for k, p in params.items():
            got = p.detach().double() - torch.from_numpy(p0[k]).double()
            want = np.asarray(jparams[k], np.float64) - p0[k]
            if i == 0 and method == "dino":       # the warm-up's lr 0
                assert not got.any() and not want.any(), k
                continue
            assert rel_l2(got, want) <= OPT_TOL, f"step {i} {k}: {rel_l2(got, want)}"


# --- head and loss -------------------------------------------------------------

@pytest.mark.parametrize("use_bn,norm_last_layer", [(False, True), (True, False)])
def test_dino_head_forward_and_gradients_match_jax(use_bn, norm_last_layer):
    """The default head (no BN, g frozen), and one with BNs (train mode) and a
    trainable g; the JAX head's names map onto the upstream ones."""
    x = np.random.default_rng(1).standard_normal((6, 48)).astype(np.float32)
    jhead = jdino.DINOHead(out_dim=24, use_bn=use_bn, norm_last_layer=norm_last_layer,
                           hidden_dim=40, bottleneck_dim=16)
    variables = jax.jit(functools.partial(jhead.init, train=False))(jax.random.key(3),
                                                                    jnp.asarray(x))
    variables = {**variables,
                 "params": jax.tree.map(lambda p: p + 0.01 * jnp.sin(jnp.arange(p.size).reshape(
                     p.shape)), variables["params"])}

    def jloss(params, x):
        out, mut = jhead.apply({**variables, "params": params}, x, train=True,
                               mutable=["batch_stats"])
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape))), (out, mut)

    (_, (jout, jmut)), (jg, jgx) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(variables["params"],
                                                                 jnp.asarray(x))
    head = dino.DINOHead(48, 24, use_bn=use_bn, norm_last_layer=norm_last_layer,
                         hidden_dim=40, bottleneck_dim=16)
    head.load_state_dict(dino_head_state_dict_from_jax(
        as_np(variables["params"]), as_np(variables.get("batch_stats", {}))), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = head.train()(xt)
    (out * torch.cos(torch.arange(out.numel()).reshape(out.shape).float())).sum().backward()
    close(out.detach(), jout, "output")
    close(xt.grad, jgx, "input gradient")
    want = dino_head_state_dict_from_jax(as_np(jg), _zero_stats_like(as_np(jg)))
    for k, p in head.named_parameters():
        if not p.requires_grad:
            assert k == "last_layer.weight_g" and not want[k].any()
            continue
        close(p.grad, want[k], f"d{k}")
    if use_bn:
        new = dino_head_state_dict_from_jax(as_np(variables["params"]),
                                            as_np(jmut["batch_stats"]))
        for k, v in head.state_dict().items():
            if "running" in k:
                close(v, new[k], k)


def test_dino_loss_and_centre_match_jax():
    rng = np.random.default_rng(4)
    student = [rng.standard_normal((B, 20)).astype(np.float32) for _ in range(4)]
    teacher = [rng.standard_normal((B, 20)).astype(np.float32) for _ in range(2)]
    center = rng.standard_normal((1, 20)).astype(np.float32)

    def jloss(s):
        return jdino.dino_loss(s, [jnp.asarray(t) for t in teacher], jnp.asarray(center),
                               np.float32(0.04))

    (jl, jc), jg = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(s) for s in student])
    st = [torch.from_numpy(s).requires_grad_(True) for s in student]
    loss, c = dino.dino_loss(st, [torch.from_numpy(t) for t in teacher],
                             torch.from_numpy(center), float(np.float32(0.04)))
    loss.backward()
    close(loss.detach(), jl, "loss")
    close(c, jc, "centre")
    assert not c.requires_grad
    for i, (s, g) in enumerate(zip(st, jg)):
        close(s.grad, g, f"d student {i}")


# --- the one draw of a step -------------------------------------------------------

def test_one_rngs_dict_gives_one_dropout_mask_and_the_port_draws_one(monkeypatch):
    """Two flax applies with one rngs dict draw one dropout mask, whatever
    their inputs; the port's legacy step draws one keep mask (its four
    encoder forwards take it: test_two_dino_steps_of_audiontt_...)."""
    mods, jstate = jax_state(KW, "dino")
    key = jax.random.key(5)
    first = jax_keep_masks(mods, jstate, key, lms(1))
    second = jax_keep_masks(mods, jstate, key, lms(2))
    assert len(first) == len(second) == 1 and first[0].shape == (B, 8, 2048)
    np.testing.assert_array_equal(first[0], second[0])
    assert 0.6 < first[0].mean() < 0.8
    other = jax_keep_masks(mods, jstate, jax.random.key(6), lms(1))
    assert (other[0] != first[0]).any()

    cfg = default_config(method="dino", device="cpu", **KW)
    encoder, _ = build_encoder(cfg)
    draws = legacy_steps.draw_legacy_step(torch.Generator().manual_seed(1), cfg,
                                          (B, 1, 64, 32), encoder)
    assert len(draws.dropout) == 1 and draws.dropout[0].shape == (B, 8, 2048)


def test_audiontt_with_local_crops_raises_and_distributed_raises():
    cfg = default_config(method="dino", device="cpu", **dict(KW, local_crops_number=2))
    with pytest.raises(ValueError, match="sized for 64 mel bins"):
        legacy_steps.init_legacy_state(cfg, torch.Generator(), "dino", device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        legacy_steps.init_legacy_state(default_config(method="byola", distributed=True),
                                       torch.Generator(), "byola", device="cpu")


# --- steps ------------------------------------------------------------------------

def two_dino_steps(kw, monkeypatch, dropout: bool):
    """Two steps against JAX's; with dropout, JAX's one keep mask a step
    handed to the port, whose four encoder forwards (student's and
    teacher's) must each take it."""
    jcfg, mods, jstate, jax_step, cfg, state = make_pair(kw, "dino", monkeypatch)
    start = jstate
    step = legacy_steps.make_dino_train_step(cfg)
    seen = []
    if dropout:
        for enc in (state.modules["encoder"], state.modules["target"]["encoder"]):
            enc.register_forward_pre_hook(lambda m, args: seen.append(args[1]))
    # momenta far below the schedule's 0.996 -> 1: the EMA's move, (1 - m)
    # times the online change, then stands well above the fp32 rounding of
    # the target's weights, and m apart from 1 - m
    temps, moms = (0.04, 0.05), (0.9, 0.95)
    for i in range(2):
        key = jax.random.key(10 + i)
        batch = lms(20 + i)
        keep = jax_keep_masks(mods, jstate, key, batch) if dropout else []
        jstate, jm = jax_step.step(jstate, batch, key, temps[i], moms[i])
        draws = StepDraws(None, port_views(key, cfg, batch.shape),
                          [torch.from_numpy(keep[0].copy())] if keep else None)
        m = step(state, torch.from_numpy(batch), temps[i], moms[i], draws=draws)
        close(m["loss"], jm["loss"], f"loss {i}")
        if dropout:
            assert len(seen) == 4 * (i + 1)
            assert all(torch.equal(k, draws.dropout[0]) for k in seen[-4:])
    assert max(jax_step.gaps) < VIEWS_RTOL
    assert len(jax_step.views) == 2 + cfg.local_crops_number
    compare(state, jstate, "dino", start)
    np.testing.assert_allclose(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank, atol=1e-6)
    assert state.step == 2 and state.scheduler.count == 2


def test_two_dino_steps_of_audiontt_with_dropout_match_jax(monkeypatch):
    two_dino_steps(KW, monkeypatch, dropout=True)


def test_two_dino_steps_of_vit_tiny_with_local_crops_match_jax(monkeypatch):
    """vit_tiny at width 64, depth 2, 4 heads (both packages' size tables
    patched) with 2 local crops of 16x16: the student's local forwards at one
    patch + CLS (the attention at N = 2), the position table resized."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})
    two_dino_steps(VIT_KW, monkeypatch, dropout=False)


def test_twenty_dino_steps_at_the_proof_lr_track_jax(monkeypatch):
    """Twenty steps of AudioNTT2022 (dropout on) at the learning proof's
    peak lr (base_lr 0.002 at batch 128: 1e-3) on the recipe's schedules
    (the weight decay's cosine, the teacher momentum's from 0.996, the
    teacher temperature 0.04): each step's loss, and the change of both
    stacks from their start, against JAX's."""
    niter = 20
    kw = dict(KW, base_lr=1e-3 * 256 / B, wd=0.04, final_wd=0.4)
    _, mods, jstate, jax_step, cfg, state = make_pair(kw, "dino", monkeypatch, niter)
    start = jstate
    step = legacy_steps.make_dino_train_step(cfg)
    momentum = cosine_scheduler(0.996, 1.0, 1, niter)
    gaps = []
    for i in range(niter):
        key = jax.random.key(100 + i)
        batch = lms(200 + i)
        keep = jax_keep_masks(mods, jstate, key, batch)
        jstate, jm = jax_step.step(jstate, batch, key, 0.04, momentum[i])
        m = step(state, torch.from_numpy(batch), 0.04, np.float32(momentum[i]),
                 draws=StepDraws(None, port_views(key, cfg, batch.shape),
                                 [torch.from_numpy(keep[0].copy())]))
        gaps.append(abs(float(m["loss"]) - float(jm["loss"])) / abs(float(jm["loss"])))
    print("loss gaps", max(gaps), gaps)
    assert max(gaps) <= LONG_LOSS_RTOL, gaps
    compare_changes(state, jstate, start, "dino")
