"""--steps_per_dispatch and --profile_dir of the port on the CPU, at small
widths (ssl_audio_tpu_torch/train/steps.py make_multi_train_step,
train/loop.py Trainer._train_one_epoch_multi and the profiler trace), and
the device state the CUDA graph of a window needs: the LR schedule's table
and counter, the mixup ring's count and position, masking at a tensor
ratio, and old checkpoints with int counters.

The window grouping is held against the JAX Trainer's own
_train_one_epoch_multi with its multi_step and train_step replaced by
recorders: no JAX epoch is compiled.  On the CPU the multi path runs the
window's steps eagerly, in order, so an epoch at N = 3 must equal the same
epoch at N = 1 bit for bit.  The graph itself (the card) is held against
the eager step in tests/test_torch_kernels_cuda.py and chip_smoke.py phase
12."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.augment import augmentations as JA
from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train import loop as jax_loop
from ssl_audio_tpu.train import optim as jax_optim
from ssl_audio_tpu_torch import main as tmain
from ssl_audio_tpu_torch.augment import augmentations as A
from ssl_audio_tpu_torch.config import config_from_args, default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train import optim
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import init_train_state
from tests.test_torch_augment import jax_mixup_draws

# 4 clips a batch (the JAX Trainer of the grouping test shards 8 over its
# CPU devices), crop 32, a narrow projector, a bank of 12 (not a multiple
# of the batch, so the ring wraps mid-batch)
SMALL = ["--device", "cpu", "--batch_size", "4", "--crop_frames", "32",
         "--projector_hidden_dim", "64", "--projector_out_dim", "32", "--num_workers", "1",
         "--mixup_n_memory", "12"]
TABLE_RTOL = 1e-6    # the fp32 table against the float64 factor and JAX's fp32 schedule
MIXUP_TOL = 1e-6     # fp32 exp / log of the same values in another library


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures (the suite runs six
    workers on the host's cores; tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_vits(monkeypatch):
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})


# ------------------------------------------------- (i) the window grouping

WINDOW_CASES = {
    "fixed_ratio_token_drop": dict(mask=True, mask_ratio=0.5, token_drop=True),
    "sine_schedule_token_drop": dict(mask=True, mask_ratio_schedule=True, mask_beta=0.9,
                                     token_drop=True),
    "random_ratio": dict(mask=True, random_mask_ratio=True, mask_beta=0.6, token_drop=True),
}


def grouping_kw(options):
    return dict(dataset="synthetic", model_type="vit_tiny", batch_size=8, crop_frames=32,
                synthetic_steps_per_epoch=7, epochs=1, steps_per_dispatch=3,
                projector_hidden_dim=32, projector_out_dim=8, mixup_n_memory=8, num_workers=1,
                no_eval=True, seed=3, **options)


def jax_grouping(kw):
    """(kind, ratio, len_keep) per step of the JAX Trainer's epoch."""
    tr = jax_loop.Trainer(jax_config(**kw))
    seen = []

    def multi_step(state, batches, keys, ratios, monitor, len_keep=None):
        assert batches.shape[0] == len(ratios) == kw["steps_per_dispatch"]
        seen.extend(("window", float(np.float32(r)), len_keep) for r in np.asarray(ratios))
        return state, {"loss": jnp.zeros(len(ratios))}, monitor

    def train_step(state, batch, key, ratio, monitor, len_keep=None):
        seen.append(("tail", float(np.float32(ratio)), len_keep))
        return state, {"loss": jnp.zeros(())}, monitor

    tr.multi_step, tr.train_step = multi_step, train_step
    tr.train_one_epoch(1)
    return seen


def port_grouping(kw):
    tr = Trainer(default_config(**kw, device="cpu"), log=lambda line: None)
    seen = []

    def multi_step(state, batches, ratios, monitor, len_keep=None, *, gen):
        assert batches.shape[0] == len(ratios) == kw["steps_per_dispatch"]
        assert gen is tr.gen
        seen.extend(("window", float(np.float32(r)), len_keep) for r in ratios)
        return {"loss": torch.zeros(len(ratios))}, monitor

    def train_step(state, batch, gen=None, monitor=None, mask_ratio=0.0, len_keep=None):
        seen.append(("tail", float(np.float32(mask_ratio)), len_keep))
        return {"loss": torch.zeros(())}, monitor

    tr.multi_step, tr.train_step = multi_step, train_step
    tr.train_one_epoch(1)
    return seen


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_grouping_matches_jax(small_vits, case):
    """Two windows of 3 and a tail of 1 over 7 steps: per step the kind of
    dispatch, the mask ratio (drawn from default_rng(seed + 17) on both
    sides) and the window's len_keep, from its first ratio."""
    kw = grouping_kw(WINDOW_CASES[case])
    ours, ref = port_grouping(kw), jax_grouping(kw)
    assert [k for k, _, _ in ours] == ["window"] * 6 + ["tail"]
    assert ours == ref
    if case == "sine_schedule_token_drop":
        assert len({lk for _, _, lk in ours}) == 3      # None, then two token-drop counts
    if case == "random_ratio":
        assert {lk for _, _, lk in ours} == {None} and len({r for _, r, _ in ours}) > 2


# ----------------------------------------- (ii) multi path == single path

EQUAL_CASES = {
    "audiontt_lars_mixup_wav": ["--dataset", "synthetic_wav", "--lr_schedule"],
    "vit_tiny_masked_adamw_schedule": ["--dataset", "synthetic_wav", "--model_type", "vit_tiny",
                                       "--optimizer", "AdamW", "--lr", "1e-3", "--lr_schedule",
                                       "--mask", "--random_mask_ratio", "--mask_beta", "0.6"],
    "vit_tiny_token_drop_sgd_pre_norm": ["--dataset", "synthetic", "--model_type", "vit_tiny",
                                         "--optimizer", "SGD", "--lr", "1e-2", "--mask",
                                         "--mask_ratio", "0.5", "--pre_norm"],
}


def assert_tree_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("case", list(EQUAL_CASES))
def test_multi_path_equals_single_path_bit_for_bit(small_vits, case):
    """7 steps at N = 3 (two windows and a tail) against 7 single steps,
    from the same seed: losses, parameters, running statistics, optimizer
    state, LR schedule, mixup ring, step counters and generator, bit for
    bit."""
    runs = []
    for n in ("1", "3"):
        cfg = config_from_args([*SMALL, *EQUAL_CASES[case], "--epochs", "2",
                                "--synthetic_steps_per_epoch", "7", "--steps_per_dispatch", n])
        tr = Trainer(cfg, log=lambda line: None)
        assert (tr.multi_step is None) == (n == "1")
        tr.train_one_epoch(1)
        runs.append(tr)
    single, multi = runs
    assert multi.epoch_losses == single.epoch_losses
    assert_tree_equal(multi.state.state_dict(), single.state.state_dict(), "state")
    assert multi.state.step == single.state.step == 7
    assert int(multi.state.lr_schedule.counter) == multi.state.lr_schedule.count == 7
    assert torch.equal(multi.gen.get_state(), single.gen.get_state())
    if multi.state.aug.mixup is not None:
        ring = multi.state.aug.mixup
        assert (int(ring.count), int(ring.pos)) == (12, 28 % 12)


def test_multi_step_function_runs_the_window_in_order():
    """make_multi_train_step on the CPU: N steps of the single step, metrics
    stacked per step, the monitor folded over all of them."""
    from ssl_audio_tpu_torch.train.steps import init_monitor, make_multi_train_step, \
        make_train_step

    cfg = config_from_args([*SMALL, "--dataset", "synthetic"])
    batches = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4, 1, 64, 32)).astype(np.float32))
    out = []
    for multi in (False, True):
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(1)
        mon = init_monitor("cpu")
        if multi:
            metrics, mon = make_multi_train_step(cfg, 3)(state, batches, [0.0] * 3, mon,
                                                         gen=gen)
            losses = metrics["loss"]
        else:
            step, losses = make_train_step(cfg), []
            for b in batches:
                m, mon = step(state, b, gen=gen, monitor=mon)
                losses.append(m["loss"])
            losses = torch.stack(losses)
        out.append((losses, mon, state.state_dict()))
    (l1, m1, s1), (l3, m3, s3) = out
    assert l3.shape == (3,) and torch.equal(l1, l3)
    assert_tree_equal(m3, m1, "monitor")
    assert int(m3["count"]) == 3
    assert_tree_equal(s3, s1, "state")
    with pytest.raises(ValueError):
        make_multi_train_step(cfg, 3)(state, batches[:2], [0.0] * 2, m3, gen=gen)


def test_main_runs_windows_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The entry point with --steps_per_dispatch 3 and --device cpu: an
    epoch of 5 steps (a window and a 2-step tail) and its checkpoint."""
    monkeypatch.chdir(tmp_path)
    tr = tmain.main([*SMALL, "--dataset", "synthetic_wav", "--epochs", "1",
                     "--synthetic_steps_per_epoch", "5", "--steps_per_dispatch", "3",
                     "--no_eval", "--save_base_dir", "out"])
    assert tr.state.step == 5 and np.isfinite(tr.epoch_losses[1])
    assert "Epoch [1/1] loss=" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "out/results/synthetic_wav/*/model_1.pt"))


# ----------------------------------------------------------- (iii) LR table

@pytest.mark.parametrize("optimizer", ["LARS", "AdamW"])
def test_lr_table_matches_the_factor_and_jax(optimizer):
    """The device table over every step of a 30-epoch x 7-step run (warm-up
    and cosine) against lr_factor_fn and JAX's fp32 schedule; the counter
    advances once per optimizer step and a step past the end takes the
    last factor."""
    kw = dict(dataset="synthetic", batch_size=256, epochs=300, lr_schedule=True,
              optimizer=optimizer, lr=1e-3)
    cfg, jcfg = default_config(**kw), jax_config(**kw)
    niter = 7
    params = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.ones(2))]
    opt, sched = optim.make_optimizer(cfg, params, niter)
    schedule = (sched or opt).schedule
    table = schedule.table.numpy().astype(np.float64)
    assert table.shape == (300 * niter,) and table.dtype == np.float64
    f, f_jax = optim.lr_factor_fn(cfg, niter), jax_optim.lr_factor_fn(jcfg, niter)
    steps = np.arange(len(table))
    host = np.array([f(s) for s in steps])
    jax_vals = np.asarray(jax.vmap(f_jax)(jnp.asarray(steps, jnp.int32)), np.float64)
    np.testing.assert_allclose(table, host, rtol=TABLE_RTOL, atol=0)
    np.testing.assert_allclose(table, jax_vals, rtol=TABLE_RTOL, atol=0)
    for k in range(3):
        assert float(schedule.factor()) == np.float32(host[k])
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
        if sched is not None:
            sched.step()
    assert schedule.count == int(schedule.counter) == 3
    if sched is not None:
        lr = opt.param_groups[0]["lr"]
        assert torch.is_tensor(lr) and float(lr) == np.float32(np.float32(1e-3) *
                                                               np.float32(host[3]))
    schedule.set_count(len(table) + 5)
    assert float(schedule.factor()) == np.float32(host[-1])


# --------------------------------------------------- (iv) the mixup ring

def test_device_mixup_ring_matches_jax_as_it_fills_and_wraps(tmp_path):
    """A bank of 6 and batches of 4: empty, filled, wrapped mid-batch twice.
    Each step's output and bank against JAX's mixup_byola on the same
    draws; count and pos stay device tensors and a checkpoint writes
    ints."""
    n_mem, shape = 6, (4, 1, 8, 5)
    ours = A.init_mixup_state(n_mem, shape[1:])
    jstate = JA.init_mixup_state(n_mem, shape[1:])
    rng = np.random.default_rng(0)
    for step in range(4):
        x = rng.standard_normal(shape).astype(np.float32)
        key = jax.random.key(step)
        ref, jstate = JA.mixup_byola(key, jnp.asarray(x), jstate, ratio=0.2)
        alpha, u = jax_mixup_draws(key, shape[0], 0.2)
        out = A.apply_mixup(torch.from_numpy(x), ours, alpha, A.bank_index(u, ours.count))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MIXUP_TOL,
                                   rtol=MIXUP_TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(ours.bank.numpy(), np.asarray(jstate.bank))
        assert torch.is_tensor(ours.count) and ours.count.dtype == torch.int32
        assert (int(ours.count), int(ours.pos)) == (int(jstate.count), int(jstate.pos))
    assert (int(ours.count), int(ours.pos)) == (6, 16 % 6)
    torch.save(ours.state_dict(), tmp_path / "ring.pt")
    sd = torch.load(tmp_path / "ring.pt", weights_only=True)
    assert type(sd["count"]) is int and type(sd["pos"]) is int
    fresh = A.init_mixup_state(n_mem, shape[1:])
    fresh.load_state_dict(sd)
    assert (int(fresh.count), int(fresh.pos)) == (6, 4) and torch.equal(fresh.bank, ours.bank)


# ------------------------------------------- (v) masking at a tensor ratio

def boundary_ratios(L):
    """Ratios at which float32 L * (1 - r) lands on or next to an integer,
    0 included."""
    out = {0.0, 0.05, 0.25, 0.5, 0.75, 0.9}
    for k in range(L + 1):
        r = np.float32(1.0 - k / L)
        out.update(float(v) for v in (r, np.nextafter(r, np.float32(0)),
                                      np.nextafter(r, np.float32(1))) if 0.0 <= v < 1.0)
    return sorted(out)


@pytest.mark.parametrize("L", [8, 24, 25, 48])
def test_tensor_ratio_masking_equals_float_and_jax(L):
    """random_token_mask at a 0-d tensor ratio == at the float ratio == JAX's
    random_token_mask at a traced ratio on the same noise."""
    B = 3
    jax_mask = jax.jit(jvit.random_token_mask, static_argnums=(1, 2))
    for i, r in enumerate(boundary_ratios(L)):
        key = jax.random.key(i)
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (B, L))))
        ref = np.asarray(jax_mask(key, B, L, jnp.float32(r)))
        at_float = vit.random_token_mask(noise, r)
        at_tensor = vit.random_token_mask(noise, torch.tensor(r, dtype=torch.float32))
        assert torch.equal(at_tensor, at_float), r
        np.testing.assert_array_equal(at_tensor.numpy(), ref, err_msg=str(r))
        lk = vit.len_keep_for(L, torch.tensor(r, dtype=torch.float32))
        assert lk.dtype == torch.int64 and int(lk) == vit.len_keep_for(L, r)


def test_vit_forward_at_a_tensor_ratio_equals_the_float_ratio(small_vits):
    """The ViT teacher's forward (key-bias masking) at a 0-d tensor ratio
    and at the float: the same latent; at 0 the same as unmasked."""
    enc = vit.get_mae_vit("tiny", [16, 16], False, img_size=(64, 32))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 1, 64, 32))
                         .astype(np.float32))
    noise = torch.rand(3, 8, generator=torch.Generator().manual_seed(0))
    for r in (0.0, 0.25, 0.75):
        a = enc(x, mask_ratio=r, noise=noise)
        b = enc(x, mask_ratio=torch.tensor(r), noise=noise)
        assert torch.equal(a, b), r


# ------------------------------------------------------ (vi) --profile_dir

@pytest.mark.parametrize("spd", ["1", "3"])
def test_profile_dir_writes_a_trace_at_one_step_per_dispatch(tmp_path, spd):
    """An 11-step first epoch at --steps_per_dispatch 1 traces iteration 10
    (the trace runs from min(10, niter - 1) to 20 or the epoch's end) into
    --profile_dir; at N > 1 the JAX package's warning and no trace."""
    lines = []
    trace_dir = tmp_path / "trace"
    cfg = config_from_args([*SMALL, "--dataset", "synthetic", "--epochs", "1",
                            "--synthetic_steps_per_epoch", "11", "--profile_dir",
                            str(trace_dir), "--steps_per_dispatch", spd])
    Trainer(cfg, log=lines.append).train_one_epoch(1)
    written = sorted(glob.glob(str(trace_dir / "*.json")))
    if spd == "1":
        assert [os.path.basename(p) for p in written] == ["trace_steps_10-10.json"]
        assert os.path.getsize(written[0]) > 0
        assert any("profiler trace written to" in line for line in lines)
    else:
        assert written == []
        assert any(line.startswith("WARNING: --profile_dir is only supported with "
                                   "--steps_per_dispatch 1") for line in lines)


# ------------------------------------------------- (vii) old checkpoints

@pytest.mark.parametrize("optimizer", ["LARS", "AdamW", "SGD"])
def test_checkpoint_with_int_counters_and_lambdalr_loads(optimizer):
    """A state dict as code before the device counters wrote it: the mixup
    ring's and the running norm's counters as ints, LARS's count as an int,
    AdamW / SGD stepped by torch's optimizer with a float lr under a
    LambdaLR.  It loads; the device counters, the lr tensors and the host
    counters continue from it, and a step trains on."""
    kw = ["--dataset", "synthetic", "--optimizer", optimizer, "--lr", "1e-2",
          "--lr_schedule", "--pre_norm", "--epochs", "10"]
    cfg = config_from_args([*SMALL, *kw])
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    sd = state.state_dict()
    factor = optim.lr_factor_fn(cfg, 2)
    params = [p for p in state.modules.parameters() if p.requires_grad]
    if optimizer != "LARS":
        old = (torch.optim.SGD(params, lr=1e-2) if optimizer == "SGD"
               else torch.optim.AdamW(optim._decay_groups(params, cfg.wd), lr=1e-2))
        sched = torch.optim.lr_scheduler.LambdaLR(old, factor)
        for _ in range(5):
            for p in params:
                p.grad = torch.ones_like(p)
            old.step()
            sched.step()
        for p in params:
            p.grad = None
        sd["optimizer"], sd["scheduler"] = old.state_dict(), sched.state_dict()
        assert isinstance(sd["optimizer"]["param_groups"][0]["lr"], float)
    else:
        sd["optimizer"]["count"] = 5
    sd["augment"]["mixup"].update(count=8, pos=8)
    sd["augment"]["running_norm"]["n"] = 3
    sd["step"] = 5
    state.load_state_dict(sd)
    assert state.version == 1 and state.step == 5
    assert state.lr_schedule.count == int(state.lr_schedule.counter) == 5
    assert (int(state.aug.mixup.count), int(state.aug.mixup.pos)) == (8, 8)
    assert int(state.aug.running_norm.n) == 3
    if optimizer != "LARS":
        for group in state.optimizer.param_groups:
            assert torch.is_tensor(group["lr"])
            assert float(group["lr"]) == np.float32(np.float32(1e-2) * np.float32(factor(5)))
        assert state.scheduler.last_epoch == 5
        assert state.scheduler.get_last_lr() == sched.get_last_lr()
    from ssl_audio_tpu_torch.train.steps import make_train_step

    batch = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 1, 64, 32))
                             .astype(np.float32))
    loss = make_train_step(cfg)(state, batch, gen=torch.Generator().manual_seed(1))["loss"]
    assert torch.isfinite(loss) and state.step == 6 and state.lr_schedule.count == 6
    assert int(state.aug.mixup.count) == 12 and int(state.aug.running_norm.n) == 4
