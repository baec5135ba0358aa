"""The hyperparameter sweep and the last CLI utilities of the port
(ssl_audio_tpu_torch/run_hyperparameter_sweep.py, utils/metric_logger.py,
utils/plotting.py, utils/flops.py) against the JAX package's
(run_hyperparameter_sweep.py, ssl_audio_tpu/utils/...) on the CPU.

The search (trial parameters, pruning, the files written) is held to JAX's
exactly: both mains run with the same scripted run_trial, through the
built-in search and through the optuna double (tests/optuna_double.py).  A
tiny built-in sweep then trains and probes for real on the CPU.  FLOPs are
held to closed-form counts of the module structure (chip_smoke.py
audiontt_macs, vit_macs, which phase 18 holds on the card too)."""
import csv
import json
import sys

import numpy as np
import pytest

import run_hyperparameter_sweep as jsweep
import tests.optuna_double as optuna_double
from chip_smoke import audiontt_macs, vit_macs
from ssl_audio_tpu.utils import flops as jflops
from ssl_audio_tpu.utils import metric_logger as jml
from ssl_audio_tpu.utils import plotting as jplot
from ssl_audio_tpu_torch import run_hyperparameter_sweep as sweep
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.utils import flops, metric_logger, plotting
from ssl_audio_tpu_torch.utils.logging_utils import make_csv_logger
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TUNES = [["lr", "wd"], list(sweep.HYPERPARAMETERS), ["mask_beta", "virtual_crop_scale"]]
SMALL = ["--dataset", "synthetic", "--batch_size", "8", "--synthetic_steps_per_epoch", "1",
         "--crop_frames", "32", "--projector_hidden_dim", "64", "--projector_out_dim", "32",
         "--mixup_n_memory", "16", "--num_workers", "1"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("tune", TUNES, ids=["lr_wd", "all", "mask_crop"])
def test_sample_space_draws_the_jax_parameters(seed, tune):
    assert sweep.HYPERPARAMETERS == jsweep.HYPERPARAMETERS
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        got, want = sweep.sample_space(a, tune), jsweep.sample_space(b, tune)
        assert got == want and [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]


def test_median_pruner_decides_as_jax():
    rng = np.random.default_rng(3)
    scores = rng.random((6, 4))
    for mod in (sweep, jsweep):
        mod.decisions = []
    for mod in (sweep, jsweep):
        trials = []
        cb = mod.median_pruner(trials)
        for i, row in enumerate(scores):
            t = mod.Trial(number=i, params={})
            trials.append(t)
            for epoch, s in enumerate(row, 1):
                t.scores.append(float(s))
                keep = cb(t, epoch)
                mod.decisions.append(keep)
                if not keep:
                    t.pruned = True
                    break
    assert sweep.decisions == jsweep.decisions and not all(sweep.decisions)


def scripted_run_trial(base_cfg, params, trial, report_cb, eval_mode="linear",
                       data_dir="data"):
    """run_trial's contract with scores from the parameters alone."""
    for epoch in range(1, 4):
        trial.scores.append(round((trial.number * 0.37 + epoch * 0.11 + params["lr"]) % 1, 6))
        if report_cb and not report_cb(trial, epoch):
            trial.pruned = True
            break
    return trial.best


@pytest.mark.parametrize("with_optuna", [False, True], ids=["builtin", "optuna_double"])
def test_the_sweep_writes_the_jax_files(with_optuna, tmp_path, monkeypatch, capsys):
    """Both mains with the same scripted trials: the same CSV rows, the same
    sweep_out JSON and the same BEST line, through the built-in search and
    through optuna (the double)."""
    if with_optuna:
        monkeypatch.setitem(sys.modules, "optuna", optuna_double)
    else:
        monkeypatch.setitem(sys.modules, "optuna", None)      # import optuna -> ImportError
    out = {}
    argv = ["--dataset", "synthetic", "--n_trials", "5"]
    for name, mod, extra in (("jax", jsweep, []), ("port", sweep, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "run_trial", scripted_run_trial)
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        best = mod.main(argv + extra)
        lines = capsys.readouterr().out.splitlines()
        with open(tmp_path / name / "logs/hparams/synthetic/audiontt/intermediate_values.csv") as f:
            rows = list(csv.reader(f))
        out[name] = (best, [line for line in lines if line.startswith(("BEST:", "[trial"))],
                     rows, json.loads((tmp_path / name / "sweep_results.json").read_text()))
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) == 5 and out["port"][2][0][1:5:2] == ["lr", "wd"]


def test_a_tiny_builtin_sweep_trains_and_probes_on_the_cpu(tmp_path, monkeypatch, capsys):
    """2 trials of 2 epochs at batch 8 on `synthetic`: JAX's trial
    parameters for seed 0, two probe scores each in (0, 1], the CSV and
    JSON in JAX's formats, BEST printed."""
    monkeypatch.setitem(sys.modules, "optuna", None)
    monkeypatch.chdir(tmp_path)
    best = sweep.main(["--device", "cpu", "--n_trials", "2", "--train_epochs", "2", *SMALL])
    want = [jsweep.sample_space(r, ["lr", "wd"]) for r in [np.random.default_rng(0)] for _ in
            range(2)]
    with open(tmp_path / "logs/hparams/synthetic/audiontt/intermediate_values.csv") as f:
        rows = list(csv.reader(f))
    assert [r[:5] for r in rows] == [[str(i), "lr", repr(w["lr"]), "wd", repr(w["wd"])]
                                     for i, w in enumerate(want)]
    scores = [float(s) for r in rows for s in r[5:]]
    assert len(scores) == 4 and all(0 < s <= 1 for s in scores)
    assert json.loads((tmp_path / "sweep_results.json").read_text()) == best
    assert best["params"] in want and best["value"] == max(scores)
    assert "BEST: " + json.dumps(best) in capsys.readouterr().out
    assert (tmp_path / "logs/hparams/synthetic/audiontt/intermediate_values.png").exists()


# ------------------------------------------------------------- CLI utilities

def test_metric_logger_prints_the_jax_strings(monkeypatch, capsys):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr("time.time", lambda: float(next(clock)))
    vals = np.random.default_rng(2).random((30, 2))
    printed = {}
    for name, mod in (("jax", jml), ("port", metric_logger)):
        sv = mod.SmoothedValue(window_size=5)
        for v in vals[:, 0]:
            sv.update(float(v), n=2)
        sv.synchronize_between_processes()         # outside a process group: nothing
        log = mod.MetricLogger(delimiter=" | ")
        log.add_meter("lr", mod.SmoothedValue(fmt="{value:.6f}"))
        for i in log.log_every(range(12), 5, header="Epoch: [1]"):
            log.update(loss=vals[i, 0], lr=vals[i, 1])
        log.synchronize_between_processes()
        printed[name] = (str(sv), sv.median, sv.avg, sv.global_avg, sv.max, sv.value, str(log),
                         capsys.readouterr().out)
    assert printed["port"] == printed["jax"]
    assert "eta: " in printed["port"][-1] and "Total time" in printed["port"][-1]
    with pytest.raises(AttributeError):
        metric_logger.MetricLogger().missing


def test_read_loss_csv_reads_the_trainer_log_as_jax(tmp_path):
    logger = make_csv_logger(str(tmp_path))
    for e in (1, 2):
        for s in range(3):
            logger.info("epoch,{},step,{},loss,{},data_time,{:.4f},step_time,{:.4f}".format(
                e, 3 * (e - 1) + s, 10.0 / (1 + s + e), 0.01, 0.2))
        logger.info("epoch,{},step,{},linear_score,{}".format(e, 3 * e, 0.5))
    for h in logger.handlers:
        h.flush()
    path = str(tmp_path / "log.csv")
    got = plotting.read_loss_csv(path)
    assert got == jplot.read_loss_csv(path) and len(got[0]) == 6
    out = plotting.plot_losses({"a": path}, str(tmp_path / "loss.png"))
    assert out.endswith("loss.png") and (tmp_path / "loss.png").stat().st_size > 0


def test_count_params_equals_jax():
    import jax

    from ssl_audio_tpu.config import default_config as jax_config
    from ssl_audio_tpu.models.wrapper import build_encoder as jax_build_encoder
    from ssl_audio_tpu_torch.train.state import build_encoder

    for model_type in ("audiontt", "resnet18"):
        cfg = jax_config(model_type=model_type, crop_frames=32)
        enc, _ = jax_build_encoder(cfg)
        shapes = jax.eval_shape(lambda k: enc.init({"params": k}, np.zeros(
            (1, 1, 64, 32), np.float32), train=False), jax.random.key(0))
        port, _ = build_encoder(default_config(model_type=model_type, crop_frames=32))
        assert flops.count_params(port) == jflops.count_params(shapes["params"])


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_counts_the_module_structure(train, capsys):
    """The same count whichever block-1 and attention path the model is
    configured with (the fused ones hide their products from torch), equal
    to the closed forms, linear in the batch; main prints JAX's line."""
    for fused in (True, False):
        cfg = default_config(crop_frames=96, fused_conv=fused)
        info = flops.model_flops(cfg, batch_size=3, train=train)
        assert info["flops_per_batch"] == 3 * 2 * audiontt_macs(96)
        assert info["flops_per_sample"] == 2 * audiontt_macs(96) and info["embed_dim"] == 3072
        cfg = default_config(model_type="vit_base", fused_attention=fused)
        info = flops.model_flops(cfg, batch_size=2, train=train)
        assert info["flops_per_batch"] == 2 * 2 * vit_macs(768, 12, (4, 6), (16, 16))
    flops.main(["--model_type", "audiontt"])
    assert capsys.readouterr().out.strip() == (
        f"audiontt: params={6333376 / 1e6:.2f}M "
        f"flops/sample={2 * audiontt_macs(96) / 1e9:.3f} GFLOPs embed_dim=3072")
