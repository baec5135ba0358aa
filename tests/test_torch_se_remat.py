"""--squeeze_excitation (AudioNTT2022's SE blocks) and --remat (gradient
checkpointing of the ViT encoder's blocks) in the port, on the CPU.

SE: the port's AudioNTT2022(squeeze_excitation=True) against the JAX
module (ssl_audio_tpu/models/audiontt.py SEBlock), weights carried over by
audiontt_state_dict_from_jax (the reference's features.{4,9} layout): eval
and train mode, with the fused block 1 / pool-reordered block 2 on and off,
fp32 to 1e-4 (BASELINE.md) and bf16 by tests/test_torch_bf16_serving.hold;
two Barlow Twins steps against JAX's make_train_step on JAX's views (as
tests/test_torch_resnet_train.py: loss, parameters and statistics to TOL,
LARS's momentum to MOMENT_TOL).

Remat: the port's step with --remat equals the step without it, bit for
bit (every random number of a block is an input, and the recompute runs
the same kernels on the same values), in fp32, in bf16 and with
--masked_recon; the port with remat against JAX with remat (the two cases
of tests/test_remat.py: forward and gradients, then train steps with
token drop); windows of steps against single steps for SE and remat."""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_vit_train_step as vit_steps
from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu.utils.torch_export import export_audiontt_state_dict
from ssl_audio_tpu_torch.config import config_from_args, default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.models.audiontt import AudioNTT2022
from ssl_audio_tpu_torch.models.precision import bf16_params, forward_bf16
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import build_encoder, init_train_state
from ssl_audio_tpu_torch.train.steps import draw_step, make_device_frontend, make_train_step
from ssl_audio_tpu_torch.utils.weights import audiontt_state_dict_from_jax, train_state_dicts_from_jax
from tests.test_torch_bf16_serving import hold
from tests.test_torch_byol import MOMENT_TOL, JaxViews, as_np, lars_momentum
from tests.test_torch_multi_dispatch import SMALL, assert_tree_equal
from tests.test_torch_resnet_train import PARAM_ROUNDING, step_gaps
from tests.test_torch_train_step import STATS, VIEWS_ATOL, port_draws

TOL = 1e-4
B, L = 4, 8000
# SE layout: block 2's conv is features.5, and its bias, before a batch norm,
# takes a gradient of 0 + float noise (features.4 is the SE block)
SE_ZERO_GRAD = ("features.0.bias", "features.5.bias")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


@pytest.fixture
def small_vits(monkeypatch):
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})


# ------------------------------------------------------------------- SE

@pytest.fixture(scope="module")
def se_variables():
    """JAX AudioNTT2022(squeeze_excitation=True) variables (key 0) with
    BatchNorm scales (a quarter negative), shifts and running statistics
    away from their init, as numpy arrays."""
    v = jax.tree.map(np.array, JaxAudioNTT2022(squeeze_excitation=True).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)), train=False))
    rng = np.random.default_rng(1)
    for i in range(2):
        bn = v["params"]["encoder"][f"BatchNorm_{i}"]
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        bn["scale"] = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
        bn["scale"][:16] *= -1.0
        bn["bias"] = (0.2 * rng.standard_normal(64)).astype(np.float32)
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    return v


def se_model(variables, **kw):
    m = AudioNTT2022(squeeze_excitation=True, **kw)
    m.load_state_dict(audiontt_state_dict_from_jax(variables, squeeze_excitation=True),
                      strict=True)
    return m


def test_se_layout_is_the_reference_export(se_variables):
    """features.{4,9}.excitation.{0,2}.weight, block 2 at features.{5,6}: the
    conversion equals torch_export's reference-layout state dict, which loads
    strict; build_encoder routes --squeeze_excitation to AudioNTT2022 only."""
    ours = audiontt_state_dict_from_jax(se_variables, squeeze_excitation=True)
    ref = export_audiontt_state_dict(se_variables, squeeze_excitation=True)
    assert ours.keys() == ref.keys() == se_model(se_variables).state_dict().keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    assert ours["features.4.excitation.0.weight"].shape == (4, 64)
    assert ours["features.9.excitation.2.weight"].shape == (64, 4)
    assert ours["features.5.weight"].shape == (64, 64, 3, 3)
    enc, _ = build_encoder(default_config(squeeze_excitation=True))
    assert enc.squeeze_excitation and enc.block_len == 5
    enc, _ = build_encoder(default_config(model_type="vit_tiny", squeeze_excitation=True))
    assert isinstance(enc, vit.MaskedAutoencoderViT)


@pytest.mark.parametrize("fused,T", [(True, 96), (False, 95)])
def test_se_eval_forward_matches_jax(se_variables, fused, T):
    """Eval mode: the fused block 1's eval kernel at even sizes, the plain
    block at odd T, SE after each block."""
    x = np.random.default_rng(2).standard_normal((2, 1, 64, T)).astype(np.float32)
    ref = np.asarray(JaxAudioNTT2022(squeeze_excitation=True, fused_conv_eval=fused).apply(
        se_variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = se_model(se_variables, fused_conv=fused).eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 3072)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("fused_and_reorder", [True, False])
def test_se_train_forward_grads_and_stats_match_jax(se_variables, no_jax_dropout,
                                                    fused_and_reorder):
    """One train-mode call: output, every parameter gradient (SE's Linears
    included) and the running statistics; dropout out on both sides."""
    rng = np.random.default_rng(3)
    x = np.round(rng.standard_normal((3, 1, 64, 32)) * 2).astype(np.float32) / 2
    dout = rng.standard_normal((3, 3072)).astype(np.float32)
    jmodel = JaxAudioNTT2022(squeeze_excitation=True, fused_conv=fused_and_reorder,
                             pool_reorder=fused_and_reorder)

    def loss(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": se_variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * dout), (out, mut["batch_stats"])

    (_, (ref, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        se_variables["params"])
    m = se_model(se_variables, fused_conv=fused_and_reorder,
                 pool_reorder=fused_and_reorder).train()
    out = m(torch.from_numpy(x), torch.full((3, 8, 2048), 0.7))     # keep / 0.7 == 1
    (out * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))
    want = audiontt_state_dict_from_jax({"params": as_np(grads), "batch_stats": as_np(new_stats)},
                                        squeeze_excitation=True)
    for k, p in m.named_parameters():
        if k in SE_ZERO_GRAD:
            assert float(p.grad.abs().max()) < 1e-3 and float(want[k].abs().max()) < 1e-3
            continue
        assert float((p.grad - want[k]).abs().max()) <= TOL * max(float(want[k].abs().max()),
                                                                  1.0), k
    for k, v in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, want[k], atol=1e-5, rtol=1e-5, msg=k)


def test_se_bf16_matches_jax_bf16(se_variables, no_jax_dropout):
    """bf16 compute mode (models/precision.py), eval and train mode, against
    JAX's AudioNTT2022 on bf16 parameters and input: SE's Linears in bf16."""
    x = np.random.default_rng(4).standard_normal((2, 1, 64, 96)).astype(np.float32)
    bf16_tree = dict(se_variables, params=jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                                       se_variables["params"]))
    for train in (False, True):
        jmodel = JaxAudioNTT2022(squeeze_excitation=True, fused_conv=train,
                                 fused_conv_eval=not train, pool_reorder=train)
        kw = dict(train=train, mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)}) \
            if train else dict(train=False)
        ref32 = jmodel.apply(se_variables, jnp.asarray(x), **kw)
        ref16 = jmodel.apply(bf16_tree, jnp.asarray(x, jnp.bfloat16), **kw)
        ref32, ref16 = (r[0] if train else r for r in (ref32, ref16))
        m = se_model(se_variables, fused_conv=True, pool_reorder=True).train(train)
        with torch.no_grad():
            out = forward_bf16(m, bf16_params(m), torch.from_numpy(x),
                               *((torch.full((2, 24, 2048), 0.7),) if train else ()))
        hold(out, np.asarray(ref16, np.float32), np.asarray(ref32),
             f"SE {'train' if train else 'eval'} mode in bf16")


def test_two_barlow_twins_steps_with_se_match_jax(monkeypatch, no_jax_dropout):
    """AudioNTT2022 --squeeze_excitation at the defaults (LARS), the fused
    block 1 on both sides (tests/test_torch_byol.py CONV says why), two
    steps on JAX's views: the losses, parameters, running statistics and the
    mixup bank to TOL, LARS's momentum to MOMENT_TOL and the step taken to
    that plus PARAM_ROUNDING."""
    kw = dict(dataset="synthetic_wav", batch_size=B, crop_frames=32, projector_hidden_dim=256,
              mixup_n_memory=8, seed=0, squeeze_excitation=True, fused_conv=True,
              pool_reorder=True)
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    views = JaxViews(mods, jcfg, monkeypatch, factory=jax_make_train_step)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")

    def jax_dicts(tree):
        return train_state_dicts_from_jax(as_np(tree), as_np(jstate.batch_stats))

    for name, module in state.modules.items():
        module.load_state_dict(jax_dicts(jstate.params)[name], strict=True)
    step = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))
    rng = np.random.default_rng(0)
    for i in range(2):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        key = jax.random.key(100 + i)
        before = {n: {k: v.clone() for k, v in m.state_dict().items()}
                  for n, m in state.modules.items()}
        jbefore = jax_dicts(jstate.params)
        jstate, jmetrics = views.step(jstate, wav, key, 0.0)
        metrics = step(state, torch.from_numpy(wav), draws=port_draws(key, cfg))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=TOL,
                                   err_msg=f"loss of step {i}")
        gaps = step_gaps(dict(state.modules.items()), state.optimizer, jax_dicts(jstate.params),
                         jax_dicts(lars_momentum(jstate.opt_state, jstate.params)), before,
                         jbefore, zero_grad=SE_ZERO_GRAD)
        print(f"step {i}: {gaps}")
        assert gaps["param"] <= TOL and gaps["stats"] <= TOL, f"step {i}"
        assert gaps["momentum"] <= MOMENT_TOL, f"step {i}"
        assert gaps["took"] <= MOMENT_TOL + PARAM_ROUNDING, f"step {i}"
        np.testing.assert_allclose(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank,
                                   atol=TOL, err_msg="mixup bank")
    assert max(views.gaps) <= VIEWS_ATOL


# ---------------------------------------------------------------- remat

REMAT_CASES = {
    # vit_tiny, the teacher masked by key bias; DropPath keep masks drawn
    "key_bias_drop_path": dict(mask=True, mask_ratio=0.5, token_drop=False),
    # the reconstruction decoder (its blocks are not checkpointed) on token drop
    "masked_recon_token_drop": dict(mask=True, mask_ratio=0.5, masked_recon=True),
    # the bf16 compute mode: the recompute runs over the step's bf16 copies
    "bf16": dict(mask=True, mask_ratio=0.5, use_fp16=True),
    # the attention Function (its plain versions on the CPU) re-run inside the recompute
    "fused_attention": dict(mask=True, mask_ratio=0.5, token_drop=False, fused_attention=True),
}


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_equals_the_step_without_it(small_vits, monkeypatch, case):
    """The same state and draws, one step with --remat and one without: the
    loss, every gradient and every tensor of the train state after the step,
    bit for bit; the checkpointed blocks did recompute (their forward ran
    twice)."""
    kw = dict(dataset="synthetic_wav", model_type="vit_tiny", batch_size=B, crop_frames=32,
              projector_hidden_dim=64, projector_out_dim=32, mixup_n_memory=8, seed=0,
              **REMAT_CASES[case])
    if case == "key_bias_drop_path":
        monkeypatch.setattr(vit, "get_mae_vit", lambda *a, _f=vit.get_mae_vit, **k:
                            _f(*a, drop_path_rate=0.2, **k))
        import ssl_audio_tpu_torch.train.state as tstate
        monkeypatch.setattr(tstate, "get_mae_vit", vit.get_mae_vit)
    wav = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal((B, L)))
                           .astype(np.float32))
    runs = []
    for remat in (False, True):
        cfg = default_config(**kw, remat=remat, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                                 device="cpu")
        encoder = state.modules["encoder"]
        assert encoder.spec.remat == remat
        calls, forward = [], encoder.blocks[0].forward
        encoder.blocks[0].forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
        draws = draw_step(torch.Generator().manual_seed(1), cfg, (B, L), encoder, wav=True)
        if case == "key_bias_drop_path":
            assert draws.drop_path is not None
        len_keep = None if not cfg.token_drop else 8 - int(8 * cfg.mask_ratio)
        metrics = make_train_step(cfg, frontend=make_device_frontend(cfg, STATS))(
            state, wav, draws=draws, mask_ratio=cfg.mask_ratio, len_keep=len_keep)
        del encoder.blocks[0].forward
        grads = {k: p.grad.clone() for k, p in state.modules.named_parameters()
                 if p.grad is not None}
        runs.append((metrics, grads, state.state_dict(), len(calls)))
    (m0, g0, s0, c0), (m1, g1, s1, c1) = runs
    assert c1 == c0 + 2          # the teacher's and the student's passes, recomputed
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k].contiguous(), g1[k].contiguous()), k
    assert_tree_equal(s1, s0, "state")


def test_remat_forward_and_gradients_match_jax(small_vits):
    """tests/test_remat.py's first case against the port: the JAX ViT with
    remat (train=False, as there) and the port's with remat in train mode
    (which a ViT without DropPath computes alike): the output and every
    gradient of mean(out^2) within TOL."""
    x = np.random.default_rng(3).standard_normal((2, 1, 64, 96)).astype(np.float32)
    jmodel = jvit.get_mae_vit("tiny", [16, 16], False, img_size=(64, 96), remat=True)
    variables = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)

    def loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
        return (out ** 2).mean(), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    m = vit.get_mae_vit("tiny", (16, 16), False, img_size=(64, 96), remat=True)
    from ssl_audio_tpu_torch.utils.weights import vit_state_dict_from_jax

    m.load_state_dict(vit_state_dict_from_jax(as_np(variables["params"]), None, m.spec),
                      strict=True)
    out = m.train()(torch.from_numpy(x))
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * float(np.abs(np.asarray(ref)).max()))
    want = vit_state_dict_from_jax(as_np(grads), None, m.spec)
    for k, p in m.named_parameters():
        if p.grad is None:
            continue
        scale = max(float(want[k].abs().max()), 1e-6)
        assert float((p.grad - want[k]).abs().max()) <= TOL * scale + 1e-7, k


def test_remat_train_steps_match_jax_remat(monkeypatch, small_vits):
    """tests/test_remat.py's second case against the port: two Barlow Twins
    steps with --remat on both sides, the teacher masked at 0.25 by token
    drop, through tests/test_torch_vit_train_step.py's comparison (losses,
    running statistics, AdamW's first moments)."""
    monkeypatch.setitem(vit_steps.CASES, "remat_token_drop",
                        (dict(mask=True, mask_ratio=0.25, remat=True), 0.25, 6))
    vit_steps.test_two_vit_train_steps_match_jax(monkeypatch, None, "remat_token_drop")


# ----------------------------------------------------------------- windows

@pytest.mark.parametrize("flags", [["--squeeze_excitation"],
                                   ["--model_type", "vit_tiny", "--remat", "--mask",
                                    "--mask_ratio", "0.5", "--optimizer", "AdamW",
                                    "--lr", "1e-3"]])
def test_windows_equal_single_steps_bit_for_bit(small_vits, flags):
    """5 steps at N = 3 (a window and a tail of two) against 5 single steps,
    from the same seed: losses, the whole train state and the generator."""
    runs = []
    for n in ("1", "3"):
        cfg = config_from_args([*SMALL, "--dataset", "synthetic_wav", *flags, "--epochs", "1",
                                "--synthetic_steps_per_epoch", "5", "--steps_per_dispatch", n])
        tr = Trainer(cfg, log=lambda line: None)
        tr.train_one_epoch(1)
        runs.append(tr)
    single, multi = runs
    assert multi.epoch_losses == single.epoch_losses
    assert_tree_equal(multi.state.state_dict(), single.state.state_dict(), "state")
    assert torch.equal(multi.gen.get_state(), single.gen.get_state())
