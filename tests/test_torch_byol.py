"""The BYOL-style step of the port (ssl_audio_tpu_torch/train/steps.py
make_byol_train_step, the target in train/state.py, the online mask ratios
of train/loop.py) against the JAX package's make_byol_train_step (jitted),
on the CPU at small sizes, with AudioNTT2022; tests/test_torch_byol_vit.py
holds the ViT, the windows and main_bt_byol.

Draws and views: the JAX step's keys give the crop starts and augmentation
parameters (tests/test_torch_train_step.port_draws); dropout is the
identity on both sides, as there; a ViT's token-mask noise is handed to both
(tests/test_torch_vit.JaxDraws).  The port's own views are held against the
JAX step's within VIEWS_ATOL, and the port's step then runs on the JAX
step's views: the views' last bits flip the step's ReLU and pool decisions
(tests/test_torch_train_step.py says how far that moves a gradient), and
this file holds the step itself.

Tolerances: TOL (1e-4, relative to each tensor's largest value) for the
losses, parameters, running statistics and the mixup bank; the optimizer's
momentum per tensor in relative L2 to MOMENT_TOL (VIT_MOMENT_TOL) and the
step each parameter took to that plus PARAM_ROUNDING, for the reasons
stated there; the EMA bit for bit against the same arithmetic in numpy and
within an fp32 ulp of JAX's optax.incremental_update."""
import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.train import loop as jax_loop
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import make_byol_train_step as jax_make_byol_train_step
from ssl_audio_tpu.train.steps import make_device_frontend as jax_frontend
from ssl_audio_tpu_torch.config import config_from_args, default_config
from ssl_audio_tpu_torch.train import loop
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import (
    make_byol_train_step,
    make_device_frontend,
    pass_sizes,
)
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests.test_torch_train_step import STATS, VIEWS_ATOL, port_draws

TOL = 1e-4
B, L = 4, 8000
# block 1 fused on both sides (the port's wrapper takes its plain version on
# the CPU, which follows the Pallas kernel's order of work): unfused, XLA's
# and torch's convolutions differ in the last bits, a pool decision flips and
# block 1's momentum moves by 1.1e-3
CONV = dict(fused_conv=True, pool_reorder=True)
# The optimizer state per tensor, relative L2: at B = 4 the Barlow Twins loss
# amplifies fp32 noise (tests/test_torch_vit_train_step.py MOMENT_TOL); on
# the same views the momentum of every tensor reads 4e-5..1.4e-4 (two steps)
MOMENT_TOL = 5e-4
# the ViT's, as for the Barlow Twins step (tests/test_torch_vit_train_step.py
# MOMENT_TOL): measured up to 6.1e-4 here (a LayerNorm bias)
VIT_MOMENT_TOL = 1e-3
# LARS moves a weight by ~2e-4 of its size a step, so the fp32 rounding of the
# parameter itself is up to ~5e-4 of the step taken
# (tests/test_torch_train_step.py DELTA_TOL): added to the momentum's bound
PARAM_ROUNDING = 1e-3
CONV_KW = dict(dataset="synthetic_wav", batch_size=B, crop_frames=32, projector_hidden_dim=256,
               mixup_n_memory=8, seed=0, predictor=True, **CONV)
# LARS for the ViT too: AdamW's first steps are ~lr sign(g) per element, so an
# element whose gradient is float noise on both sides moves the other way by
# 2 lr (tests/test_torch_vit_train_step.py) and the next step's activations
# with it; LARS's step follows the gradient continuously
VIT_KW = dict(dataset="synthetic_wav", model_type="vit_tiny", batch_size=B, crop_frames=32,
              projector_hidden_dim=256, mixup_n_memory=8, seed=0, predictor=True,
              optimizer="LARS", lr_weights=0.1, lr_biases=0.001, wd=1e-5, stop_gradient=True)
# conv biases before a batch norm: their gradient is 0 + float noise
ZERO_GRAD = ("features.0.bias", "features.4.bias")
ZERO_GRAD_ATOL = 1e-3
# the final LayerNorm's bias shifts every sample's latent alike, which the
# projector's BatchNorm removes: its Barlow Twins gradient is 0 + float noise
# (measured up to 2.6e-4 in its momentum here, two BT terms a step), to which
# masked_recon adds a real one
VIT_ZERO_GRAD = ("norm.bias",)
VIT_ZERO_GRAD_ATOL = 1e-3
SMALL = ["--device", "cpu", "--batch_size", "4", "--crop_frames", "32",
         "--projector_hidden_dim", "64", "--projector_out_dim", "32", "--num_workers", "1",
         "--mixup_n_memory", "12", "--predictor"]


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch thread per test (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def close(a, b, what, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a), b, atol=tol * scale, rtol=tol, err_msg=what)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_modules(jstate, vit_spec=None) -> dict:
    """The JAX state's online and target stacks as the port's state dicts:
    {"encoder": ..., "head": ..., "predictor": ..., "target": {...}}."""
    online = train_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats),
                                        vit_spec=vit_spec)
    online["target"] = train_state_dicts_from_jax(as_np(jstate.target_params),
                                                  as_np(jstate.target_batch_stats),
                                                  vit_spec=vit_spec)
    return online


def load_from_jax(state, jstate, vit_spec=None) -> None:
    sds = jax_modules(jstate, vit_spec)
    for name in ("encoder", "head", "predictor"):
        state.modules[name].load_state_dict(sds[name], strict=True)
        state.modules["target"][name].load_state_dict(sds["target"][name], strict=True)


def stacks(state) -> dict:
    """(stack, module name) -> the port's module."""
    out = {}
    for name in ("encoder", "head", "predictor"):
        out[("online", name)] = state.modules[name]
        out[("target", name)] = state.modules["target"][name]
    return out


class JaxViews:
    """The JAX step jitted with its views as an extra output, and the
    port's step made to take them: the port's own views are made (the mixup
    bank advances) and held against JAX's within VIEWS_ATOL, then JAX's go
    on.  step(jstate, wav, key, ratio, len_keep) -> (jstate, metrics)."""

    def __init__(self, mods, jcfg, monkeypatch):
        self.views, self.gaps = None, []
        raw = jax_make_byol_train_step(mods, frontend=jax_frontend(jcfg, STATS), raw=True)

        def step_and_views(jstate, wav, key, ratio, len_keep=None):
            seen = []
            make_views = mods.make_views
            mods.make_views = lambda *a: seen.append(make_views(*a)) or seen[0]
            try:
                jstate, metrics = raw(jstate, wav, key, ratio, len_keep=len_keep)
            finally:
                mods.make_views = make_views
            return jstate, metrics, seen[0][0]

        self.jitted = jax.jit(step_and_views, static_argnames=("len_keep",))
        apply_pair_views = tsteps.apply_pair_views

        def replay(batch, aug, cfg, draws):
            ours = apply_pair_views(batch, aug, cfg, draws)
            theirs = [torch.from_numpy(v) for v in self.views]
            self.gaps.append(max(float((a - b).abs().max()) for a, b in zip(ours, theirs)))
            return theirs

        monkeypatch.setattr(tsteps, "apply_pair_views", replay)

    def step(self, jstate, wav, key, ratio, len_keep=None):
        jstate, metrics, views = self.jitted(jstate, jnp.asarray(wav), key, np.float32(ratio),
                                             len_keep=len_keep)
        self.views = [np.array(v) for v in views]
        return jstate, metrics


def conv_draws(key, cfg):
    """port_draws for every encoder pass of a BYOL step: dropout keep masks
    that scale back to exactly 1 (the JAX side's dropout is the identity)."""
    draws = port_draws(key, cfg)
    draws.dropout = [torch.full((B, t // 4, 2048), 0.7) for _, t in pass_sizes(cfg, byol=True)]
    return draws


def lars_momentum(opt_state, params):
    """LARS's momentum out of the JAX optimizer state: the tree beside the
    parameters (a tuple of the online and target trees when one LARS spans
    both), zeros where the frozen label masks a parameter out."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "count"):
        return opt_state.mu
    found = []

    def visit(x):
        if hasattr(x, "mu") and hasattr(x, "count"):
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


def compare(state, jstate, before, jbefore, vit_spec=None, moment_tol=MOMENT_TOL):
    """Every parameter and running statistic of both stacks, LARS's momentum
    and the step each trained parameter took."""
    want = jax_modules(jstate, vit_spec)
    for (stack, name), module in stacks(state).items():
        ref = want[name] if stack == "online" else want["target"][name]
        sd = module.state_dict()
        assert sd.keys() == ref.keys()
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                close(v, ref[k], f"{stack} {name}.{k}")
    # the optimizer's state per trained parameter
    mu = lars_momentum(jstate.opt_state, jstate.params)
    trees = list(mu) if isinstance(mu, tuple) else [mu]
    moments = [train_state_dicts_from_jax(as_np(t), as_np(jstate.batch_stats),
                                          vit_spec=vit_spec) for t in trees]
    zero = VIT_ZERO_GRAD if vit_spec else ZERO_GRAD
    zero_atol = VIT_ZERO_GRAD_ATOL if vit_spec else ZERO_GRAD_ATOL
    worst = 0.0
    for (stack, name), module in stacks(state).items():
        if stack == "target" and len(moments) == 1:
            for p in module.parameters():
                assert p not in state.optimizer.state and not p.requires_grad
            continue
        jm = moments[0 if stack == "online" else 1][name]
        for k, p in module.named_parameters():
            if not p.requires_grad:                 # the frozen patch projection
                continue
            got, ref = state.optimizer.state[p]["mu"], jm[k]
            if not ref.any():           # a 1-D parameter the loss does not reach
                assert not got.any(), f"{stack} {name}.{k}"
                continue
            if k in zero:
                assert float((got - ref).abs().max()) < zero_atol, f"{stack} {name}.{k}"
                continue
            err = rel_l2(got, ref)
            worst = max(worst, err)
            assert err <= moment_tol, f"momentum of {stack} {name}.{k}: {err:.2e}"
            took = p.detach().double() - before[(stack, name)][k].double()
            ref_module = want[name] if stack == "online" else want["target"][name]
            jtook = ref_module[k].double() - jbefore[(stack, name)][k].double()
            assert float(jtook.norm()) > 0, f"{stack} {name}.{k} did not move"
            assert rel_l2(took, jtook) <= moment_tol + PARAM_ROUNDING, \
                f"step taken by {stack} {name}.{k}"
    return worst


def snapshot(state) -> dict:
    return {key: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for key, m in stacks(state).items()}


def jsnapshot(jstate, vit_spec=None) -> dict:
    want = jax_modules(jstate, vit_spec)
    return {(stack, name): (want[name] if stack == "online" else want["target"][name])
            for stack in ("online", "target") for name in ("encoder", "head", "predictor")}


def run_conv(monkeypatch, **options):
    """Two BYOL steps of AudioNTT2022 on both sides -> (state, jstate, the
    worst optimizer-state gap, the port's view gaps)."""
    kw = {**CONV_KW, **options}
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2, byol=True)
    views = JaxViews(mods, jcfg, monkeypatch)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=True,
                             device="cpu")
    load_from_jax(state, jstate)
    step = make_byol_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    rng = np.random.default_rng(0)
    worst = 0.0
    for i in range(2):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        key = jax.random.key(100 + i)
        before, jbefore = snapshot(state), jsnapshot(jstate)
        jstate, jmetrics = views.step(jstate, wav, key, 0.0)
        metrics = step(state, torch.from_numpy(wav), draws=conv_draws(key, cfg))
        for k in ("loss", "bt_loss"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL,
                                       err_msg=f"{k} of step {i}")
        worst = max(worst, compare(state, jstate, before, jbefore))
        np.testing.assert_allclose(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank,
                                   atol=TOL, err_msg="mixup bank")
    assert state.step == int(jstate.step) == state.optimizer.count == 2
    assert max(views.gaps) <= VIEWS_ATOL
    return state, jstate, worst, views.gaps


# ------------------------------------------------------ the step against JAX

def test_two_byol_steps_match_jax(monkeypatch, no_jax_dropout):
    """--stop_gradient --predictor: the loss, the online and target
    parameters and running statistics (the target moved by the EMA alone,
    its statistics by its own forwards), LARS's momentum and the step each
    online parameter took."""
    state, _, worst, gaps = run_conv(monkeypatch, stop_gradient=True)
    print(f"worst momentum gap {worst:.2e}, view gaps {gaps}")
    for p in state.modules["target"].parameters():
        assert p.grad is None


def test_target_by_gradient_matches_jax(monkeypatch, no_jax_dropout):
    """Without --stop_gradient one LARS spans both stacks: the target takes
    gradient steps, and its predictor, which the loss never reaches, still
    moves by LARS's weight decay (JAX's zero gradient; the port's step
    fills one in), as JAX's does."""
    state, jstate, worst, _ = run_conv(monkeypatch, stop_gradient=False, HSIC=True)
    print(f"worst momentum gap {worst:.2e}")
    pred = state.modules["target"]["predictor"]
    assert all(torch.equal(p.grad, torch.zeros_like(p)) for p in pred.parameters())
    weights = [p for p in pred.parameters() if p.ndim > 1]
    assert weights and all(state.optimizer.state[p]["mu"].abs().max() > 0 for p in weights)
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == len(list(state.modules.parameters()))


def test_ema_is_jax_incremental_update(monkeypatch, no_jax_dropout):
    """The target equals the online net at init; after one --stop_gradient
    step it is s * online + (1 - s) * target of the PRE-step values, s = 1 -
    moving_average_decay: bit for bit against the same fp32 arithmetic in
    numpy, within one fp32 ulp of optax.incremental_update."""
    cfg = default_config(**{**CONV_KW, "moving_average_decay": 0.9}, stop_gradient=True,
                         device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=True,
                             device="cpu")
    online = {k: v for k, v in state.modules.state_dict().items() if not k.startswith("target.")}
    for k, v in online.items():
        assert torch.equal(state.modules.state_dict()[f"target.{k}"], v), k
    # move the target away from the online net, so both terms count
    with torch.no_grad():
        for p in state.modules["target"].parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    pre_online = {k: p.detach().clone() for k, p in state.modules.named_parameters()
                  if not k.startswith("target.")}
    pre_target = {k: p.detach().clone() for k, p in state.modules["target"].named_parameters()}
    wav = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal((B, L)))
                           .astype(np.float32))
    make_byol_train_step(cfg, frontend=make_device_frontend(cfg, STATS))(
        state, wav, gen=torch.Generator().manual_seed(2))
    s = 1.0 - 0.9
    for k, p in state.modules["target"].named_parameters():
        new, old = pre_online[k].numpy(), pre_target[k].numpy()
        want = np.float32(s) * new + np.float32(1.0 - s) * old
        assert np.array_equal(p.detach().numpy(), want), k
        jax_want = np.asarray(optax.incremental_update(jnp.asarray(new), jnp.asarray(old), s))
        np.testing.assert_array_max_ulp(p.detach().numpy(), jax_want, maxulp=1)
    # the online net moved by the optimizer, from the values the EMA read
    assert not torch.equal(state.modules["encoder"].fc[0].weight,
                           pre_online["encoder.fc.0.weight"])


def test_byol_mask_ratios_match_jax():
    """mask_ratio_for_step(byol=True): the same ratios as JAX's from the same
    host generator: U(0.02, 0.2) with probability 1/2 at
    --random_mask_ratio, the fixed ratio otherwise, never the schedule."""
    for options in (dict(mask=True, random_mask_ratio=True, mask_beta=0.7),
                    dict(mask=True, mask_ratio=0.4, mask_ratio_schedule=True, mask_beta=0.7),
                    dict(mask=True, random_mask_ratio=True, mask_ratio_schedule=True),
                    dict(mask=False, random_mask_ratio=True)):
        kw = dict(dataset="synthetic", model_type="vit_tiny", **options)
        cfg, jcfg = default_config(**kw), jax_config(**kw)
        sched = np.linspace(0.0, 0.7, 40)
        rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
        got = [loop.mask_ratio_for_step(cfg, sched, it, rng, byol=True) for it in range(40)]
        want = [jax_loop.mask_ratio_for_step(jcfg, sched, it, jrng, byol=True)
                for it in range(40)]
        assert got == want, options
        assert rng.bit_generator.state == jrng.bit_generator.state
        if options.get("random_mask_ratio") and options["mask"]:
            drawn = [r for r in got if r]
            assert drawn and all(0.02 <= r <= 0.2 for r in drawn) and 0 in got


def test_byol_state_and_step_refuse_nothing_and_copy_nothing_shared():
    """A BYOL state's target is its own copy (no tensor shared with the
    online net); with --stop_gradient it takes no gradient and sits in no
    optimizer group; a bf16 (--use_fp16) BYOL step runs and keeps fp32
    masters on both stacks."""
    cfg = config_from_args([*SMALL, "--dataset", "synthetic", "--stop_gradient",
                            "--use_fp16"])
    state = init_train_state(cfg, torch.Generator().manual_seed(0), byol=True, device="cpu")
    online = {p.data_ptr() for k, p in state.modules.named_parameters()
              if not k.startswith("target.")}
    target = list(state.modules["target"].parameters())
    assert not online & {p.data_ptr() for p in target}
    assert not any(p.requires_grad for p in target)
    in_groups = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not in_groups & {id(p) for p in target}
    before = copy.deepcopy(state.modules["target"].state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 1, 64, 32))
                         .astype(np.float32))
    m = make_byol_train_step(cfg)(state, x, gen=torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["loss"]))
    after = state.modules["target"].state_dict()
    assert all(v.dtype == before[k].dtype for k, v in after.items())
    assert any(not torch.equal(v, before[k]) for k, v in after.items())
