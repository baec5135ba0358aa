"""The port's reproduce chain (ssl_audio_tpu_torch/tools/reproduce.py) on
the fabricated tree of tests/test_reproduce.py, on the CPU: wav -> log-mel
conversion, main's pretraining, the linear CLI's probe, HEAR scene
embeddings and a probe score for each of the 18 tasks, and the results.json
aggregation, which must equal the JAX package's hear/extract_results
aggregation of the same scores directory; the port's copy of the
aggregation against JAX's on heareval-layout trees; --method dino through
convert, pretrain and probe, and a legacy run that cannot start refused
before anything is written."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from hear import extract_results as jax_extract
from ssl_audio_tpu_torch import linear as linear_cli
from ssl_audio_tpu_torch.hear import extract_results
from ssl_audio_tpu_torch.tools import reproduce
from tests.test_reproduce import fabricate_tree

TASKS = [t for group in extract_results.TASKS.values() for t in group]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_full_chain_matches_jax_aggregation(tmp_path):
    root = fabricate_tree(str(tmp_path))
    cwd = os.getcwd()
    try:
        results = reproduce.main([
            "--root", root, "--work_dir", os.path.join(root, "out"), "--device", "cpu",
            "--model_type", "audiontt", "--epochs", "1", "--batch_size", "8",
            "--epoch_save_f", "1", "--name", "smoke", "--no_eval",
            "--probe_hidden", "", "--probe_iters", "20",
            "--extra_pretrain_args",
            "--projector_hidden_dim", "64", "--projector_out_dim", "16",
            "--mixup_n_memory", "8", "--num_workers", "0",
        ])
    finally:
        os.chdir(cwd)
    assert set(results["timings_s"]) == set(reproduce.ALL_STAGES)
    # the converted log-mels, the checkpoint and the probe's scores
    lms = np.load(os.path.join(root, "data/FSD50K_lms/FSD50K.dev_audio/d0.npy"))
    assert lms.shape[0] == 64 and np.isfinite(lms).all()
    assert os.path.isfile(os.path.join(root, "data/FSD50K_lms/FSD50K.eval_audio/e0.npy"))
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "results"))
             for f in fs]
    assert len(ckpts) == 1 and ckpts[0].endswith("model_1.pt")
    assert 0.0 <= results["linear"]["score_all"] <= 1.0
    with open(os.path.join(root, "out/linear_scores.json")) as f:
        assert set(json.load(f)) == {"score_all", "score_5"}
    # every task scored; the aggregation equals JAX's over the same scores
    scores_dir = os.path.join(root, "out/hear_scores")
    with open(os.path.join(root, "out/results.json")) as f:
        agg = json.load(f)
    assert agg == results["hear"]
    assert agg == jax_extract.extract_all(scores_dir, str(tmp_path / "jax_results.json"))
    assert list(agg) == ["audiontt_smoke"]
    for group, tasks in extract_results.TASKS.items():
        got = agg["audiontt_smoke"][group]
        assert set(got) == set(tasks) | {"AVERAGE"}
        assert all(0.0 <= got[t] <= 1.0 for t in tasks)
        assert got["AVERAGE"] == pytest.approx(np.mean([got[t] for t in tasks]))


def test_aggregation_is_the_jax_aggregation(tmp_path):
    """Both layouts heareval writes ("test" and "aggregated_scores"), a
    missing task, a model with no run, two models."""
    rng = np.random.default_rng(0)
    for model in ("m1", "m2"):
        for i, task in enumerate(TASKS[: 12 if model == "m1" else 17]):
            d = tmp_path / "scores" / model / "run" / task
            d.mkdir(parents=True)
            body = ({"test": {"test_score": float(rng.random())}} if i % 2 else
                    {"aggregated_scores": {"test_score_mean": float(rng.random())}})
            (d / "test.predicted-scores.json").write_text(json.dumps(body))
    (tmp_path / "scores" / "empty").mkdir()
    ours = extract_results.extract_all(str(tmp_path / "scores"), str(tmp_path / "a.json"))
    theirs = jax_extract.extract_all(str(tmp_path / "scores"), str(tmp_path / "b.json"))
    assert ours == theirs and set(ours) == {"m1", "m2", "empty"}
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert extract_results.TASKS == jax_extract.TASKS


@pytest.mark.parametrize("method", ["dino", "byola"])
def test_legacy_methods_raise(tmp_path, method):
    """A legacy family's run that cannot start (here --fsdp) raises before
    any stage writes."""
    with pytest.raises(NotImplementedError, match="--fsdp"):
        reproduce.main(["--root", str(tmp_path), "--method", method, "--device", "cpu",
                        "--extra_pretrain_args", "--fsdp"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("method", ["dino"])
def test_legacy_chain_pretrains_and_probes(tmp_path, monkeypatch, method):
    """--method dino: the converted tree pretrains through main_pretrain, and
    the linear CLI probes the legacy checkpoint's encoder (its MLP probe at
    20 epochs instead of 500, as the full chain's HEAR probes)."""
    monkeypatch.setattr(linear_cli, "eval_linear",
                        functools.partial(linear_cli.eval_linear, max_iter=20))
    root = fabricate_tree(str(tmp_path))
    cwd = os.getcwd()
    try:
        results = reproduce.main([
            "--root", root, "--work_dir", os.path.join(root, "out"), "--device", "cpu",
            "--stages", "convert,pretrain,probe", "--method", method,
            "--model_type", "audiontt", "--epochs", "1", "--batch_size", "8",
            "--name", "smoke", "--extra_pretrain_args", "--dino_out_dim", "16",
            "--mixup_n_memory", "8", "--num_workers", "0"])
    finally:
        os.chdir(cwd)
    assert set(results["timings_s"]) == {"convert", "pretrain", "probe"}
    ckpt = os.path.join(root, "results", "fsd50k", f"{method}_audiontt", "model_1.pt")
    assert os.path.isfile(ckpt)
    assert 0.0 <= results["linear"]["score_all"] <= 1.0
