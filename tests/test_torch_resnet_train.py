"""The ResNets through the port's training paths on the CPU: two Barlow
Twins steps and a BYOL step against the JAX package's steps, windows of
steps against single steps, main with checkpoints and resume, the linear
CLI and HEAR serving of a checkpoint (tests/test_torch_resnet.py holds the
modules).

As tests/test_torch_byol.py, the JAX step is jitted with its views as an
extra output and the port's step runs on JAX's views (its own views held
within VIEWS_ATOL), so the step itself is compared; STEP_BAND says why two
steps are compared in float64 and one fp32 step within a band."""
import dataclasses
import glob
import os

import jax
import numpy as np
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu_torch import linear as tlinear
from ssl_audio_tpu_torch import main as tmain
from ssl_audio_tpu_torch.config import config_from_args, default_config
from ssl_audio_tpu_torch.hear import conv as hear_conv
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import (
    draw_step,
    make_byol_train_step,
    make_device_frontend,
    make_train_step,
)
from ssl_audio_tpu_torch.utils import weights
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests.test_torch_byol import (
    PARAM_ROUNDING,
    ZERO_GRAD_ATOL,
    JaxViews,
    as_np,
    jsnapshot,
    lars_momentum,
    load_from_jax,
    one_intra_op_thread,  # noqa: F401  (its autouse fixture: one torch thread a test)
    rel_l2,
    snapshot,
    stacks,
)
from tests.test_torch_multi_dispatch import SMALL, assert_tree_equal
from tests.test_torch_resnet import to_f64
from tests.test_torch_train_step import STATS, VIEWS_ATOL, port_draws

TOL = 1e-4
B, L = 4, 8000

STEP_KW = dict(dataset="synthetic_wav", batch_size=B, crop_frames=32, projector_hidden_dim=256,
               mixup_n_memory=8, seed=0)
# A ResNet step on these views is ill-conditioned in fp32: the views (log-mels
# of white noise) vary little around their mean, and the step's batch
# statistics (E[x^2] - E[x]^2, as flax) and ReLU and pool decisions round to
# other values with the summation order.  The port's own fp32 gradients are
# 1.5e-2 (relative L2, worst tensor) from its float64 ones on JAX's views, and
# 3e-2 from its fp32 ones when the views move by 1e-6, and a second fp32 step
# from states that differ by that much reads momenta 0.43 apart (measured).
# So two steps are held against JAX's with both packages in float64, to
# F64_TOL; one fp32 step (the BYOL one) within STEP_BAND (measured: momentum
# up to 2.9e-2, BatchNorm parameters up to 1.5e-3 of their largest value).
STEP_BAND = dict(momentum=0.1, param=5e-3)
F64_TOL = 1e-9      # measured 5e-12: the same function in float64, summed in other orders


def resnet_draws(key, cfg):
    """The JAX step's draws (tests/test_torch_train_step.port_draws) without
    dropout: a ResNet has none."""
    draws = port_draws(key, cfg)
    draws.dropout = None
    return draws


def step_gaps(modules: dict, optimizer, want: dict, mu: dict, before: dict,
              jbefore: dict, zero_grad=()) -> dict:
    """The worst gaps of a step over `modules` (name -> the port's module):
    parameters and running statistics against JAX's (`want`), of their
    tensor's largest value (at least 1); LARS's momentum against JAX's
    (`mu`; None for a module outside the optimizer) and the step each
    parameter took (after - before, each package's own), in relative L2.
    zero_grad: parameter names whose gradient is 0 + float noise, whose
    momentum is held to ZERO_GRAD_ATOL on both sides instead."""
    gaps = dict(param=0.0, stats=0.0, momentum=0.0, took=0.0)
    for name, module in modules.items():
        sd = module.state_dict()
        assert sd.keys() == want[name].keys()
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            ref = want[name][k].double()
            gap = float((v.double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
            key = "stats" if "running" in k else "param"
            gaps[key] = max(gaps[key], gap)
        if mu[name] is None:
            continue
        for k, p in module.named_parameters():
            if k in zero_grad:
                assert float(optimizer.state[p]["mu"].abs().max()) < ZERO_GRAD_ATOL, k
                assert float(mu[name][k].abs().max()) < ZERO_GRAD_ATOL, k
                continue
            gaps["momentum"] = max(gaps["momentum"],
                                   rel_l2(optimizer.state[p]["mu"], mu[name][k]))
            gaps["took"] = max(gaps["took"], rel_l2(p.detach() - before[name][k],
                                                    want[name][k] - jbefore[name][k]))
    return gaps


def assert_in_band(gaps: dict, what: str) -> None:
    print(f"{what}: {gaps}")
    assert gaps["stats"] <= TOL, what
    assert gaps["param"] <= STEP_BAND["param"], what
    assert gaps["momentum"] <= STEP_BAND["momentum"], what
    assert gaps["took"] <= STEP_BAND["momentum"] + PARAM_ROUNDING, what


def port_state_from_jax(cfg, jstate, byol=False):
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=byol,
                             device="cpu")
    if byol:
        load_from_jax(state, jstate)
    else:
        sds = train_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats))
        for name, module in state.modules.items():
            module.load_state_dict(sds[name], strict=True)
    return state


def as_fp32(obj):
    """A StepDraws (dataclasses, named tuples, lists) with every floating
    tensor in fp32: JAX draws its uniforms in float64 under enable_x64, and the
    port's augmentations take them in fp32."""
    if torch.is_tensor(obj):
        return obj.float() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: as_fp32(getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(as_fp32(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(as_fp32(v) for v in obj)
    return obj


def test_two_barlow_twins_steps_of_resnet18_regp_nrf_match_jax(monkeypatch):
    """resnet18_ReGP_NRF at the defaults (LARS), two steps from the same
    state and draws on JAX's views, both packages in float64 (STEP_BAND says
    why not fp32): the losses, every parameter, running statistic and LARS
    momentum and the step each parameter took to F64_TOL; the mixup bank
    (fp32 on the port's side) to TOL; a ResNet step draws no dropout mask."""
    kw = dict(STEP_KW, model_type="resnet18_ReGP_NRF")
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    views = JaxViews(mods, jcfg, monkeypatch, factory=jax_make_train_step)
    replay = tsteps.apply_pair_views
    monkeypatch.setattr(tsteps, "apply_pair_views",
                        lambda *a: [v.double() for v in replay(*a)])
    state = port_state_from_jax(cfg, jstate)
    state.modules.double()
    assert draw_step(torch.Generator(), cfg, (B, L), state.modules["encoder"],
                     wav=True).dropout is None
    step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    monkeypatch.setattr(weights, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))

    def jax_dicts(tree):
        return train_state_dicts_from_jax(as_np(tree), as_np(jstate.batch_stats))

    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        jstate = to_f64(jstate)
        for i in range(2):
            wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
            key = jax.random.key(100 + i)
            before = {n: {k: v.clone() for k, v in m.state_dict().items()}
                      for n, m in state.modules.items()}
            jbefore = jax_dicts(jstate.params)
            jstate, jmetrics = views.step(jstate, wav, key, 0.0)
            metrics = step(state, torch.from_numpy(wav), draws=as_fp32(resnet_draws(key, cfg)))
            np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                       rtol=F64_TOL, err_msg=f"loss of step {i}")
            gaps = step_gaps(dict(state.modules.items()), state.optimizer,
                             jax_dicts(jstate.params),
                             jax_dicts(lars_momentum(jstate.opt_state, jstate.params)),
                             before, jbefore)
            print(f"step {i}: {gaps}")
            assert max(gaps.values()) <= F64_TOL, f"step {i}"
            np.testing.assert_allclose(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank,
                                       atol=TOL, err_msg="mixup bank")
    assert max(views.gaps) <= VIEWS_ATOL
    assert state.step == int(jstate.step) == state.optimizer.count == 2


def test_byol_step_of_resnet18_matches_jax(monkeypatch):
    """resnet18 under the BYOL step (--stop_gradient --predictor), on JAX's
    views: the loss to TOL; the online and target stacks (the target moved
    by the EMA), LARS's momentum and the step each online parameter took
    within STEP_BAND; the running statistics to TOL."""
    kw = dict(STEP_KW, model_type="resnet18", stop_gradient=True, predictor=True)
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2, byol=True)
    views = JaxViews(mods, jcfg, monkeypatch)
    state = port_state_from_jax(cfg, jstate, byol=True)
    step = make_byol_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    wav = (0.3 * np.random.default_rng(0).standard_normal((B, L))).astype(np.float32)
    key = jax.random.key(100)
    before, jbefore = snapshot(state), jsnapshot(jstate)
    jstate, jmetrics = views.step(jstate, wav, key, 0.0)
    metrics = step(state, torch.from_numpy(wav), draws=resnet_draws(key, cfg))
    for k in ("loss", "bt_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL, err_msg=k)
    after = jsnapshot(jstate)
    mu = train_state_dicts_from_jax(as_np(lars_momentum(jstate.opt_state, jstate.params)),
                                    as_np(jstate.batch_stats))
    names = {f"{stack} {name}": key for key in stacks(state) for stack, name in [key]}
    gaps = step_gaps({n: stacks(state)[k] for n, k in names.items()}, state.optimizer,
                     {n: after[k] for n, k in names.items()},
                     {n: mu[k[1]] if k[0] == "online" else None for n, k in names.items()},
                     {n: before[k] for n, k in names.items()},
                     {n: jbefore[k] for n, k in names.items()})
    assert_in_band(gaps, "BYOL step")
    assert max(views.gaps) <= VIEWS_ATOL
    assert all(p.grad is None for p in state.modules["target"].parameters())


# --------------------------------------------------- windows, main, serving

def test_windows_of_resnet18_equal_single_steps_bit_for_bit():
    """5 steps at N = 3 (a window and a tail of two) against 5 single steps,
    from the same seed: losses, the whole train state and the generator."""
    runs = []
    for n in ("1", "3"):
        cfg = config_from_args([*SMALL, "--dataset", "synthetic_wav", "--model_type", "resnet18",
                                "--epochs", "1", "--synthetic_steps_per_epoch", "5",
                                "--steps_per_dispatch", n])
        tr = Trainer(cfg, log=lambda line: None)
        tr.train_one_epoch(1)
        runs.append(tr)
    single, multi = runs
    assert multi.epoch_losses == single.epoch_losses
    assert_tree_equal(multi.state.state_dict(), single.state.state_dict(), "state")
    assert torch.equal(multi.gen.get_state(), single.gen.get_state())


def test_main_checkpoint_resume_linear_and_hear(tmp_path, monkeypatch):
    """main --model_type resnet18 on the CPU: 3 epochs write model_2.pt and
    model_3.pt; resumed from model_2.pt the run ends in the same state, bit
    for bit; the linear CLI probes model_3.pt's encoder; HEAR conv serves it
    as a wrapper handed the trainer's encoder in memory does."""
    monkeypatch.chdir(tmp_path)
    fabricate_fsd50k(str(tmp_path / "data"), 2, 50, n_val=1, n_test=1)
    argv = [*SMALL, "--dataset", "synthetic_wav", "--model_type", "resnet18", "--epochs", "3",
            "--synthetic_steps_per_epoch", "1", "--epoch_save_f", "2", "--no_eval",
            "--name", "r"]
    full = tmain.main([*argv, "--save_base_dir", "a"])
    (ckpt2,) = glob.glob("a/results/synthetic_wav/resnet18_r*/model_2.pt")
    (ckpt3,) = glob.glob("a/results/synthetic_wav/resnet18_r*/model_3.pt")
    resumed = tmain.main([*argv, "--save_base_dir", "b", "--resume_path", ckpt2])
    assert list(resumed.epoch_losses) == [3] and resumed.epoch_losses[3] == full.epoch_losses[3]
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict(), "state")

    scores = tlinear.main(["--device", "cpu", "--batch_size", "4", "--num_workers", "1",
                           "--model_type", "resnet18", "--model_file_path", ckpt3,
                           "--model_name", "r"])
    assert 0.0 < scores["score_all"] <= 1.0
    cfg = default_config(model_type="resnet18", device="cpu")
    assert_tree_equal(tlinear.load_model(cfg, ckpt3).state_dict(),
                      full.state.modules["encoder"].state_dict(), "linear's encoder")

    served = hear_conv.load_model(os.path.abspath(ckpt3), "resnet18", device="cpu")
    mem = hear_conv.load_model("", "resnet18", device="cpu")
    mem.model.load_state_dict(full.state.modules["encoder"].state_dict())
    audio = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((2, 16000)))
                             .astype(np.float32))
    emb, _ = hear_conv.get_timestamp_embeddings(audio, served)
    emb_mem, _ = hear_conv.get_timestamp_embeddings(audio, mem)
    assert emb.shape == (2, 21, 512) and torch.equal(emb, emb_mem)
