"""The legacy BYOL-A family of the port (ssl_audio_tpu_torch/objectives/byol.py,
train/legacy_steps.py make_byola_train_step and MLPHead) against the JAX
package's, on the CPU at small sizes; the bf16 legacy step; and the
entry points of both legacy families: ssl_audio_tpu_torch.main_pretrain
(--method barlow|dino|byola), the legacy checkpoint grafted into linear,
and prove_learning --method byola.

Steps as in tests/test_torch_dino.py (JAX's views handed on, AudioNTT2022's
one dropout mask read off JAX and handed to the port); the same
tolerances.  The bf16 step is held to the measure of
tests/test_torch_bf16_train.py: the port's bf16 loss, gradients and
running statistics against JAX's bf16 ones within GAP_FACTOR x JAX's own
gap between its bf16 and fp32 results, and under its ceilings."""
import functools
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.objectives import byol as jbyol
from ssl_audio_tpu.train import legacy_steps as jlegacy
from ssl_audio_tpu_torch import main_pretrain
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.linear import load_model
from ssl_audio_tpu_torch.objectives import byol
from ssl_audio_tpu_torch.tools import prove_learning
from ssl_audio_tpu_torch.train import legacy_steps
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.steps import StepDraws
from ssl_audio_tpu_torch.utils.weights import (
    _zero_stats_like,
    byola_head_state_dict_from_jax,
    legacy_state_dicts_from_jax,
)
from tests.test_torch_bf16_train import GRAD_CEIL, LOSS_CEIL, hold
from tests.test_torch_dino import (
    KW,
    NITER,
    VIEWS_RTOL,
    ZERO_GRAD,
    as_np,
    close,
    compare,
    jax_keep_masks,
    jax_state,
    lms,
    load_from_jax,
    make_pair,
    port_views,
)
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

B = KW["batch_size"]
# Adam moves each element by about lr * sign(g), and where g is float noise
# the sign is the noise's: at the recipe's 3e-4 a few elements (6 of 36,864
# of block 2's conv weight) then differ by up to 2 lr, above TOL.  At 1e-5,
# the scale of DINO's 5e-4 * B / 256, that stays inside TOL; the gradients
# themselves are held through Adam's moments (MOMENT_TOL), and the recipe's
# lr by test_torch_dino.py::test_legacy_optimizer_recipe
BYOLA_KW = dict(KW, proj_dim=64, proj_size=16, moving_average_decay=0.9, base_lr=1e-5)
SMALL = ["--device", "cpu", "--dataset", "synthetic", "--model_type", "audiontt",
         "--epochs", "1", "--batch_size", "4", "--synthetic_steps_per_epoch", "2",
         "--crop_frames", "32", "--num_workers", "1", "--mixup_n_memory", "8",
         "--projector_hidden_dim", "64", "--projector_out_dim", "16", "--dino_out_dim", "16",
         "--proj_dim", "64", "--proj_size", "16", "--no_eval"]


def test_byol_loss_matches_jax():
    rng = np.random.default_rng(7)
    x, y, u, v = (rng.standard_normal((B, 12)).astype(np.float32) for _ in range(4))
    jl = jbyol.byol_symmetric_loss(*map(jnp.asarray, (x, y, u, v)))
    jg = jax.grad(lambda a: jbyol.byol_loss_fn(a, jnp.asarray(y)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    byol.byol_loss_fn(xt, torch.from_numpy(y)).sum().backward()
    close(byol.byol_symmetric_loss(*map(torch.from_numpy, (x, y, u, v))), jl, "loss")
    close(byol.byol_loss_fn(torch.from_numpy(x), torch.from_numpy(y)),
          jbyol.byol_loss_fn(jnp.asarray(x), jnp.asarray(y)), "per-sample loss")
    close(xt.grad, jg, "gradient")


def test_mlp_head_forward_gradients_and_statistics_match_jax():
    x = np.random.default_rng(8).standard_normal((6, 24)).astype(np.float32)
    jhead = jlegacy._MLPHead(hidden_dim=32, out_dim=8)
    variables = jax.jit(functools.partial(jhead.init, train=False))(jax.random.key(1),
                                                                    jnp.asarray(x))

    def jloss(params):
        out, mut = jhead.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jnp.sum(out * jnp.sin(jnp.arange(out.size).reshape(out.shape))), (out, mut)

    (_, (jout, jmut)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    head = legacy_steps.MLPHead(24, 32, 8)
    head.load_state_dict(byola_head_state_dict_from_jax(as_np(variables["params"]),
                                                        as_np(variables["batch_stats"])))
    out = head.train()(torch.from_numpy(x))
    (out * torch.sin(torch.arange(out.numel()).reshape(out.shape).float())).sum().backward()
    close(out.detach(), jout, "output")
    want = byola_head_state_dict_from_jax(as_np(jg), as_np(jmut["batch_stats"]))
    for k, p in head.named_parameters():
        close(p.grad, want[k], f"d{k}")
    for k, v in head.state_dict().items():
        if "running" in k:
            close(v, want[k], k)


def test_two_byola_steps_of_audiontt_with_dropout_match_jax(monkeypatch):
    _, mods, jstate, jax_step, cfg, state = make_pair(BYOLA_KW, "byola", monkeypatch)
    start = jstate
    step = legacy_steps.make_byola_train_step(cfg)
    for i in range(2):
        key = jax.random.key(30 + i)
        batch = lms(40 + i)
        keep = jax_keep_masks(mods, jstate, key, batch)
        jstate, jm = jax_step.step(jstate, batch, key, 0.0)
        draws = StepDraws(None, port_views(key, cfg, batch.shape),
                          [torch.from_numpy(keep[0].copy())])
        m = step(state, torch.from_numpy(batch), draws=draws)
        close(m["loss"], jm["loss"], f"loss {i}")
    assert max(jax_step.gaps) < VIEWS_RTOL
    compare(state, jstate, "byola", start)
    assert state.scheduler is None and state.center is None and state.step == 2


def test_byola_bf16_step_matches_jax(monkeypatch):
    """One --use_fp16 BYOL-A step of AudioNTT2022 from JAX's weights on
    seeded views, dropout the identity on both sides: the loss, every
    gradient (Adam's first moment / (1 - b1)) and the online encoder's new
    running statistics."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    rng = np.random.default_rng(9)
    views = [rng.standard_normal((B, 1, 64, 32)).astype(np.float32) for _ in range(2)]
    _, jstate = jax_state(BYOLA_KW, "byola")
    jmods = {fp16: jlegacy.LegacyModules(jax_config(method="byola", use_fp16=fp16, **BYOLA_KW),
                                         "byola") for fp16 in (True, False)}

    def jax_loss_and_grads(mods):
        """The JAX BYOL-A step's loss function (legacy_steps.py one_side and
        loss_fn) on the views, jitted."""
        def one_side(params, bs, v, with_predictor):
            f, enc_bs = mods.encoder_fwd(params["encoder"], bs["encoder"], v, None)
            z, _ = mods.head_fwd(mods.head, params["head"], bs["head"], f)
            if with_predictor:
                z, _ = mods.head_fwd(mods.predictor, params["predictor"], bs["predictor"], z)
            return z, enc_bs

        def loss_fn(params):
            p1, enc_bs = one_side(params, jstate.batch_stats, views[0], True)
            p2, enc_bs = one_side(params, {**jstate.batch_stats, "encoder": enc_bs}, views[1],
                                  True)
            t1, _ = one_side(jstate.target_params, jstate.target_batch_stats, views[0], False)
            t2, _ = one_side(jstate.target_params, jstate.target_batch_stats, views[1], False)
            t1, t2 = jax.lax.stop_gradient(t1), jax.lax.stop_gradient(t2)
            return jbyol.byol_symmetric_loss(p1, t2, p2, t1), enc_bs

        (loss, enc_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jstate.params)
        g = legacy_state_dicts_from_jax(as_np(grads), _zero_stats_like(as_np(grads)), "byola")
        stats = legacy_state_dicts_from_jax(
            as_np(jstate.params), {**as_np(jstate.batch_stats), "encoder": as_np(enc_bs)},
            "byola")
        return float(loss), g, stats

    j16, j32 = jax_loss_and_grads(jmods[True]), jax_loss_and_grads(jmods[False])
    cfg = default_config(method="byola", use_fp16=True, device="cpu", **BYOLA_KW)
    state = legacy_steps.init_legacy_state(cfg, torch.Generator().manual_seed(0), "byola",
                                           niter_per_ep=NITER, device="cpu")
    load_from_jax(state, jstate, "byola")
    pviews = [torch.from_numpy(v) for v in views]
    monkeypatch.setattr(tsteps, "apply_pair_views", lambda *a: pviews)
    keep = [torch.full((B, 8, 2048), 0.7)]          # 0.7 / (1 - 0.3) == 1
    m = legacy_steps.make_byola_train_step(cfg)(
        state, torch.zeros(B, 1, 64, 32), draws=StepDraws(None, None, keep))
    hold([float(m["loss"])], [j16[0]], [j32[0]], "loss", LOSS_CEIL)
    n = 0
    for name in ("encoder", "head", "predictor"):
        for k, p in state.modules[name].named_parameters():
            if f"{name}.{k}" in ZERO_GRAD:
                continue
            assert p.grad.dtype == torch.float32
            hold(p.grad.numpy(), j16[1][name][k], j32[1][name][k], f"grad {name}.{k}",
                 GRAD_CEIL)
            n += 1
    assert n >= 10
    for k, v in state.modules["encoder"].state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            hold(v.numpy(), j16[2]["encoder"][k], j32[2]["encoder"][k], f"stat {k}", LOSS_CEIL)


# --- the entry points ------------------------------------------------------------

@pytest.mark.parametrize("method", ["barlow", "dino", "byola"])
def test_main_pretrain_writes_its_checkpoint_where_jax_does(tmp_path, monkeypatch, capsys,
                                                            method):
    """Each family's checkpoint under results/{dataset}/{method}_{model}
    (the JAX entry point's directories; the port's .pt files); a legacy
    one's encoder grafts into the linear CLI's model."""
    monkeypatch.chdir(tmp_path)
    out = main_pretrain.main(["--method", method, *SMALL])
    ckpt_dir = tmp_path / "results" / "synthetic" / f"{method}_audiontt"
    assert os.listdir(ckpt_dir) == ["model_1.pt"]
    if method == "barlow":
        return
    lines = capsys.readouterr().out
    assert f"[{method}] epoch 1/1 loss=" in lines
    assert set(out.epoch_losses) == {1} and np.isfinite(out.epoch_losses[1])
    cfg = default_config(device="cpu", crop_frames=32, batch_size=4)
    encoder = load_model(cfg, str(ckpt_dir / "model_1.pt"))
    want = out.state.modules["encoder"].state_dict()
    for k, v in encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    ck = torch.load(ckpt_dir / "model_1.pt", weights_only=True)
    assert ck["epoch"] == 2 and ck["step"] == 2
    assert any(k.startswith("target.encoder.") for k in ck["model"])
    assert (ck["center"] is None) == (method == "byola")


def test_main_pretrain_refuses_wav_data_and_distributed_legacy_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = [a for a in SMALL if a != "synthetic"]
    base[base.index("--dataset") + 1:base.index("--dataset") + 1] = ["synthetic_wav"]
    with pytest.raises(ValueError, match="log-mel"):
        main_pretrain.main(["--method", "dino", *base])
    # --distributed runs under torchrun (tests/test_torch_dist_train.py); without
    # its environment it is refused before the process group or any file
    with pytest.raises(RuntimeError, match="torchrun"):
        main_pretrain.main(["--method", "dino", *SMALL, "--distributed"])
    assert not os.listdir(tmp_path)


def test_prove_learning_byola_records_its_method(tmp_path, monkeypatch):
    """The record keeps its method; --init_from starts the online stack and
    its target from the file's weights (here JAX's initial state)."""
    out, init = tmp_path / "proof.json", tmp_path / "init.pt"
    kw = dict(KW, batch_size=8, mixup_n_memory=16, proj_dim=64, proj_size=16)
    _, jstate = jax_state(kw, "byola")
    sds = legacy_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats), "byola")
    torch.save(sds, init)
    loaded = []
    load = prove_learning.load_initial_weights_
    monkeypatch.setattr(prove_learning, "load_initial_weights_",
                        lambda state, path: loaded.append(state) or load(state, path))
    probes = []
    probe_score = prove_learning.probe_score
    monkeypatch.setattr(prove_learning, "probe_score", lambda cfg, encoder, *a: probes.append(
        {k: v.clone() for k, v in encoder.state_dict().items()}) or probe_score(cfg, encoder, *a))
    record = prove_learning.main([
        "--method", "byola", "--device", "cpu",
        "--dataset", "synthetic", "--epochs", "1", "--batch_size", "8",
        "--synthetic_steps_per_epoch", "2", "--crop_frames", "32", "--num_workers", "1",
        "--mixup_n_memory", "16", "--proj_dim", "64", "--proj_size", "16",
        "--init_from", str(init), "--out", str(out)])
    assert len(loaded) == 1 and len(probes) == 2
    for k, v in sds["encoder"].items():            # the probe at init saw JAX's weights
        assert torch.equal(probes[0][k], v), k
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(record))
    assert saved["config"]["method"] == "byola" and saved["config"]["init_from"] == "init.pt"
    assert saved["resolved_config"]["optimizer"] == "Adam"
    assert [e["epoch"] for e in saved["epochs"]] == [0, 1]
    assert np.isfinite(saved["epochs"][1]["loss"])
    assert all(0.0 <= e["score"] <= 1.0 for e in saved["epochs"])
