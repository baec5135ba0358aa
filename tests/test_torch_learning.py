"""The learning proof's parts in the port, against the JAX package on the
CPU: the SyntheticMultiCue task and the hard SyntheticLMS items bit for
bit, probe_score's embeddings and score (run_hyperparameter_sweep.py's), a
miniature of the proof (the JAX package's tests/test_learning.py) whose
probe must rise above its random-init value, and the prove_learning tool's
record."""
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_hyperparameter_sweep as jsweep
import ssl_audio_tpu.config as jconfig
import ssl_audio_tpu.data.datasets as jdatasets
import ssl_audio_tpu.data.pipeline as jpipeline
import ssl_audio_tpu.eval.linear as jlinear
import ssl_audio_tpu.eval.mlp_clf as jmlp
from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu_torch import config as tconfig
from ssl_audio_tpu_torch.data import datasets as tdatasets
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.eval.linear import make_embedding_forward
from ssl_audio_tpu_torch.tools import prove_learning, sweep
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import build_encoder
from ssl_audio_tpu_torch.utils.weights import audiontt_state_dict_from_jax, mlp_clf_params_from_jax

EMB_TOL = 1e-4      # embeddings, fp32 through four layers in two frameworks
SCORE_TOL = 1e-6    # the probe's test mAP from the same start


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The module's torch work on one intra-op thread, its module fixtures'
    included (set up before any test's own fixtures): the suite runs six workers
    on the host's cores, where a pool of threads per worker waits on its
    stragglers at every small op (tens of times slower than one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- datasets

@pytest.mark.parametrize("kw", [
    {},
    dict(gain=0.7, env_width=0.2, noise=0.5, n_env=3, n_rate=2),
])
@pytest.mark.parametrize("crop_frames", [96, 40])
def test_synthetic_multicue_items_equal_jax(kw, crop_frames):
    tcfg = tconfig.default_config(dataset="synthetic_multicue", crop_frames=crop_frames)
    jcfg = jconfig.default_config(dataset="synthetic_multicue", crop_frames=crop_frames)
    ours = tdatasets.SyntheticMultiCue(tcfg, length=50, seed=3, **kw)
    ref = jdatasets.SyntheticMultiCue(jcfg, length=50, seed=3, **kw)
    assert (len(ours), ours.n_classes, ours.label_num) == (len(ref), ref.n_classes,
                                                           ref.label_num)
    for idx in (0, 1, 7, 19, 20, 49):
        (x, y), (jx, jy) = ours[idx], ref[idx]
        assert x.dtype == jx.dtype == np.float32 and x.shape == (1, 64, crop_frames)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_hard_synthetic_lms_items_equal_jax():
    """The proof's `synthetic` task: 20 classes, gain 0.5, width 0.25, noise 1."""
    kw = dict(n_classes=20, env_gain=0.5, env_width=0.25, noise=1.0, length=40, seed=990)
    ours = tdatasets.SyntheticLMS(tconfig.default_config(dataset="synthetic"), **kw)
    ref = jdatasets.SyntheticLMS(jconfig.default_config(dataset="synthetic"), **kw)
    for idx in (0, 5, 21, 39):
        np.testing.assert_array_equal(ours[idx][0], ref[idx][0])
        np.testing.assert_array_equal(ours[idx][1], ref[idx][1])


def test_calculate_norm_stats_equals_jax():
    cfg = tconfig.default_config(dataset="synthetic_multicue", crop_frames=24)
    ds = tdatasets.SyntheticMultiCue(cfg, length=30)
    ref = jdatasets.SyntheticMultiCue(jconfig.default_config(crop_frames=24), length=30)
    assert tdatasets.calculate_norm_stats(ds, 20, seed=1) == \
        jdatasets.calculate_norm_stats(ref, 20, seed=1)


def test_get_train_dataset_and_config_accept_multicue():
    from ssl_audio_tpu_torch.train.loop import get_train_dataset

    cfg = tconfig.default_config(dataset="synthetic_multicue", batch_size=4,
                                 synthetic_steps_per_epoch=3)
    assert tconfig.unsupported_settings(cfg) == []
    ds = get_train_dataset(cfg)
    assert isinstance(ds, tdatasets.SyntheticMultiCue) and len(ds) == 12
    d, h = tconfig.config_fingerprint(cfg)
    assert d["dataset"] == "synthetic_multicue" and len(h) == 16
    assert tconfig.config_fingerprint(cfg.replace(lr=0.5))[1] != h


# --------------------------------------------------------------- probe_score

def probe_loaders(make_ds, make_loader, cfg):
    task = functools.partial(make_ds, cfg)
    return tuple(make_loader(task(length=n, seed=s), batch_size=32, shuffle=False,
                             drop_last=False, num_workers=1)
                 for n, s in ((96, 990), (48, 991), (48, 992)))


def test_probe_score_matches_jax(monkeypatch):
    """The same AudioNTT2022 weights (JAX init, BN statistics set) in both
    packages: the embeddings of probe_score's forward agree to EMB_TOL and
    the probe's test mAP, started from the JAX probe's initial weights,
    to SCORE_TOL.  The JAX probe reads its class count from the sweep
    module, as the JAX proof tool sets it."""
    monkeypatch.setitem(jsweep.CLASSES, "synthetic_multicue", 20)
    v = jax.tree.map(np.array, JaxAudioNTT2022().init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)), train=False))
    rng = np.random.default_rng(1)
    for i in range(2):
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    tcfg = tconfig.default_config(dataset="synthetic_multicue", device="cpu")
    jcfg = jconfig.default_config(dataset="synthetic_multicue")
    enc, dim = build_encoder(tcfg)
    enc.load_state_dict(audiontt_state_dict_from_jax(v), strict=True)
    mods = types.SimpleNamespace(encoder=JaxAudioNTT2022())
    jstate = types.SimpleNamespace(params={"encoder": v["params"]},
                                   batch_stats={"encoder": v["batch_stats"]})

    tl = probe_loaders(tdatasets.SyntheticMultiCue, DataLoader, tcfg)
    jl = probe_loaders(jdatasets.SyntheticMultiCue, jpipeline.DataLoader, jcfg)
    x, _ = next(iter(tl[2]))
    jfwd = jlinear.make_embedding_forward(jcfg, mods, jstate.params, jstate.batch_stats)
    got = make_embedding_forward(tcfg, enc)(torch.from_numpy(x)).numpy()
    want = np.asarray(jfwd(jnp.asarray(x)))
    assert got.shape == want.shape == (32, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL * np.abs(want).max())

    want_score = jsweep.probe_score(jcfg, mods, jstate, jl, "linear")
    start = jmlp._init_mlp(jax.random.key(0), [dim, 20])
    score = sweep.probe_score(tcfg, enc, tl, 20, "linear",
                              init_params=mlp_clf_params_from_jax(start))
    assert 0.0 < score <= 1.0
    assert score == pytest.approx(want_score, abs=SCORE_TOL)


def test_sweep_eval_loaders(tmp_path, monkeypatch):
    """The synthetic splits; FSD50K's train / val / test and NSynth's train /
    valid / test on trees written here, the same batches as the JAX sweep's
    loaders."""
    from tests.test_torch_datasets import write_nsynth_tree
    from tests.test_torch_native_loader import load_jax_readers
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k

    load_jax_readers()

    cfg = tconfig.default_config(dataset="synthetic", batch_size=16, num_workers=1)
    train, val, test = sweep.get_eval_loaders(cfg)
    assert [len(ld.dataset) for ld in (train, val, test)] == [96, 48, 48]
    assert train.dataset.n_classes == sweep.CLASSES["synthetic"] == 8
    fabricate_fsd50k(str(tmp_path / "data"), 5, (40, 200), n_val=3, n_test=2)
    write_nsynth_tree(str(tmp_path / "data"), str(tmp_path / "hear"), np.random.default_rng(0))
    monkeypatch.chdir(tmp_path)
    for name, splits in (("fsd50k", ("train", "val", "test")),
                         ("nsynth", ("train", "valid", "test"))):
        kw = dict(dataset=name, batch_size=2, num_workers=1)
        loaders = sweep.get_eval_loaders(tconfig.default_config(device="cpu", **kw))
        jloaders = jsweep.get_eval_loaders(jconfig.default_config(**kw))
        assert [ld.dataset.split for ld in loaders] == list(splits)
        for ld, jld in zip(loaders, jloaders):
            got, want = list(ld), list(jld)
            assert len(got) == len(want) > 0
            for (x, y), (jx, jy) in zip(got, want):
                assert np.array_equal(x, jx) and np.array_equal(y, jy)
    with pytest.raises(ValueError):
        sweep.get_eval_loaders(cfg.replace(dataset="synthetic_wav"))


# ------------------------------------------------------------ the proof

def test_probe_improves_over_init():
    """tests/test_learning.py on the port: 2 epochs x 25 steps of batch 32,
    Adam 1e-3, projector 256 / 64, SyntheticMultiCue; the probe runs at init
    and through Trainer.fit's eval_fn hook after each epoch, and its best
    score must beat the random-init one (chance is 1/20, and a random
    encoder scores well above it).  Block 1 runs as plain convolution, BN,
    ReLU and pool, as the JAX package runs it on the CPU (its fused block is
    on for the TPU only); the fused block's plain versions compute the same
    function at twice the CPU time."""
    cfg = tconfig.default_config(
        dataset="synthetic_multicue", model_type="audiontt", batch_size=32, epochs=2,
        synthetic_steps_per_epoch=25, projector_hidden_dim=256, projector_out_dim=64,
        optimizer="Adam", lr=1e-3, num_workers=2, epoch_eval_f=1, device="cpu",
        fused_conv=False)
    task = functools.partial(tdatasets.SyntheticMultiCue, cfg)
    trainer = Trainer(cfg, dataset=task(length=cfg.synthetic_steps_per_epoch * cfg.batch_size,
                                        seed=cfg.seed), log=lambda line: None)
    mk = functools.partial(DataLoader, batch_size=cfg.batch_size, shuffle=False,
                           drop_last=False, num_workers=2)
    loaders = (mk(task(length=240, seed=990)), mk(task(length=120, seed=991)),
               mk(task(length=120, seed=992)))

    def probe(state, epoch):
        return sweep.probe_score(cfg, state.modules["encoder"], loaders, 20)

    init = probe(trainer.state, 0)
    scores = {}
    trainer.fit(eval_fn=lambda state, epoch: scores.setdefault(epoch, probe(state, epoch)))
    assert list(scores) == [1, 2]
    assert all(np.isfinite(v) for v in trainer.epoch_losses.values())
    assert max(scores.values()) > init, (init, scores)


def test_prove_learning_tool_writes_the_jax_record(tmp_path, capsys):
    out = tmp_path / "proof.json"
    record = prove_learning.main([
        "--device", "cpu", "--dataset", "synthetic_multicue", "--epochs", "2",
        "--batch_size", "8", "--synthetic_steps_per_epoch", "2", "--crop_frames", "32",
        "--projector_hidden_dim", "64", "--projector_out_dim", "32", "--optimizer", "Adam",
        "--lr", "1e-3", "--num_workers", "1", "--mixup_n_memory", "16", "--out", str(out)])
    saved = json.loads(out.read_text())
    jax_keys = {"config", "config_hash", "resolved_config", "epochs", "init_score",
                "best_score", "learned"}
    assert jax_keys <= set(saved) and saved["card"] is None and saved["device"] == "cpu"
    assert saved == json.loads(json.dumps(record))
    assert [e["epoch"] for e in saved["epochs"]] == [0, 1, 2]
    assert saved["epochs"][0]["loss"] is None
    assert all(np.isfinite(e["loss"]) for e in saved["epochs"][1:])
    assert all(0.0 <= e["score"] <= 1.0 for e in saved["epochs"])
    assert saved["init_score"] == saved["epochs"][0]["score"]
    assert saved["best_score"] == max(e["score"] for e in saved["epochs"][1:])
    assert saved["learned"] == (saved["best_score"] > saved["init_score"])
    assert saved["config"]["method"] == "barlow" and saved["config"]["epochs"] == 2
    assert saved["resolved_config"]["dataset"] == "synthetic_multicue"
    assert "probe@init=" in capsys.readouterr().out
    # a legacy family's run that cannot start here raises before training
    with pytest.raises(NotImplementedError, match="--fsdp"):
        prove_learning.main(["--device", "cpu", "--method", "dino", "--fsdp",
                             "--dataset", "synthetic_multicue", "--batch_size", "8",
                             "--synthetic_steps_per_epoch", "2", "--out", str(out)])
