"""The on-disk slice's entry points as a user runs them, on the CPU, on a
tiny FSD50K tree written here: main at --dataset fsd50k with the per-epoch
FSD50K probe, a resume bit-identical to the uninterrupted run on the C++
reader's path, and the linear CLI on the checkpoint.  One epoch of the
slice against the JAX package, from each package's loader over the same
tree, is tests/test_torch_train_step.py::test_one_fsd50k_epoch_matches_jax
(beside the steps it shares JAX's compiled operations with)."""
import glob

import numpy as np
import pytest
import torch

from ssl_audio_tpu_torch import linear as tlinear
from ssl_audio_tpu_torch import main as tmain
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k
from ssl_audio_tpu_torch.train.state import init_train_state
from tests.test_torch_checkpoint import assert_tree_equal

SMALL = ["--device", "cpu", "--dataset", "fsd50k", "--batch_size", "4", "--crop_frames", "32",
         "--projector_hidden_dim", "64", "--projector_out_dim", "32", "--num_workers", "2",
         "--mixup_n_memory", "12"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the module's tests and fixtures: the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """dev.csv with 4 train and 4 val rows (2 steps of 4 an epoch), eval.csv
    with 4; 5 classes, 1-2 labels a clip, 30-900 frames.  Enough val clips
    that the probe's validation mAP moves, so its early stopping ends it."""
    root = tmp_path_factory.mktemp("fsd50k_slice")
    fabricate_fsd50k(str(root / "data"), 4, (30, 900), seed=3, n_val=4, n_test=4, n_classes=5,
                     max_labels=2)
    return root


def test_main_probes_fsd50k_resumes_and_the_linear_cli_scores(tree, monkeypatch, capsys):
    """main at --dataset fsd50k: the C++ reader, the per-epoch FSD50K probe
    (711-frame crops) every epoch; a run resumed from model_1.pt ends in the
    uninterrupted run's state, bit for bit; the linear CLI probes the last
    checkpoint and writes its CSV line."""
    monkeypatch.chdir(tree)
    argv = [*SMALL, "--epochs", "2", "--epoch_eval_f", "1", "--epoch_save_f", "1"]
    full = tmain.main([*argv, "--save_base_dir", "a"])
    out = capsys.readouterr().out
    assert "Epoch eval disabled" not in out
    assert "DataLoader(FSD50K): C++ NativeBatchReader on 2 threads; host arrays" in out
    assert out.count("linear_score,{'score_all'") == 2
    (log,) = glob.glob("logs/training/fsd50k/*/log.csv")
    assert open(log).read().count("linear_score") == 2
    (ckpt1,) = glob.glob("a/results/fsd50k/*/model_1.pt")
    (ckpt2,) = glob.glob("a/results/fsd50k/*/model_2.pt")

    resumed = tmain.main([*argv, "--no_eval", "--save_base_dir", "b", "--resume_path", ckpt1])
    assert list(resumed.epoch_losses) == [2]
    assert resumed.epoch_losses[2] == full.epoch_losses[2]
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict())
    # the C++ path draws nothing from the dataset's generator, and a resume
    # does not restore it (as in JAX): it is where a fresh one starts
    fresh = np.random.default_rng(0).bit_generator.state
    assert resumed.dataset.rng.bit_generator.state == full.dataset.rng.bit_generator.state == fresh

    scores = tlinear.main(["--device", "cpu", "--batch_size", "4", "--num_workers", "2",
                           "--model_file_path", ckpt2, "--model_name", "slice",
                           "--model_epoch", "2"])
    assert 0.0 < scores["score_all"] <= 1.0 and len(scores["score_5"]) == 2
    (csv_log,) = glob.glob("logs/linear_eval/fsd50k/slice/log.csv")
    assert open(csv_log).read().startswith(f"epoch,2,linear_score,{scores['score_all']},")
    # an Orbax directory loads (tests/test_torch_orbax.py); a missing path raises
    with pytest.raises(FileNotFoundError):
        tlinear.load_model(default_config(device="cpu"), "results/fsd50k/run/model_2")


def test_encoder_of_the_checkpoint_is_what_the_linear_cli_probes(tree, tmp_path):
    """load_model grafts the checkpoint's encoder; an empty path gives the
    encoder drawn from the seed."""
    cfg = default_config(device="cpu", projector_hidden_dim=64, projector_out_dim=32)
    state = init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    from ssl_audio_tpu_torch.utils import checkpoint as ckpt

    ckpt.save_checkpoint(str(tmp_path / "model_1.pt"), state, 2)
    got = tlinear.load_model(cfg, str(tmp_path / "model_1.pt"))
    assert_tree_equal(got.state_dict(), state.modules["encoder"].state_dict())
    fresh = tlinear.load_model(cfg, "")
    drawn = init_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    assert_tree_equal(fresh.state_dict(), drawn.modules["encoder"].state_dict())


@pytest.fixture(scope="module")
def every_tree(tmp_path_factory):
    """A tree of each on-disk dataset, 4 clips each (one step of 4), the
    label sizes the concatenations need (FSD50K 200 classes, AudioSet 527,
    LibriSpeech's dummies as many)."""
    from tests.test_torch_datasets import write_npy_tree, write_nsynth_tree
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_audioset_wav

    root = tmp_path_factory.mktemp("every")
    data = str(root / "data")
    fabricate_fsd50k(data, 4, (30, 300), seed=1, n_classes=200, max_labels=2, wavs=True)
    fabricate_audioset_wav(data, 4, seconds=1.0, seed=2, stereo_every=3)
    write_npy_tree(data, np.random.default_rng(3))
    write_nsynth_tree(data, str(root / "hear"), np.random.default_rng(4))
    aset = root / "data" / "audioset_lms"
    with open(aset / "class_labels_indices.csv", "w") as f:
        f.write("index,mids,display_name\n" + "".join(f"{i},/m/{i},c{i}\n" for i in range(527)))
    with open(aset / "unbalanced_train_segments-downloaded.csv", "w") as f:
        f.write("".join(f"y{i},/m/{i}#/m/{i + 9}\n" for i in range(4)))
    return root


@pytest.mark.parametrize("flags", [
    ["--dataset", "audioset"], ["--dataset", "librispeech"], ["--dataset", "nsynth"],
    ["--dataset", "audioset_wav"], ["--dataset", "fsd50k+librispeech"],
    ["--dataset", "audioset+librispeech"], ["--dataset", "fsd50k", "--load_wav"],
    ["--dataset", "fsd50k", "--pre_norm"]])
def test_every_dataset_trains_through_the_trainer(every_tree, monkeypatch, flags):
    """The CLI's configuration of each dataset, its Trainer over the tree and
    an epoch of finite loss; the loader's line names the path it took."""
    from ssl_audio_tpu_torch.config import config_from_args, require_supported
    from ssl_audio_tpu_torch.train.loop import Trainer

    monkeypatch.chdir(every_tree)
    cfg = config_from_args([*SMALL, *flags, "--epochs", "1"])
    require_supported(cfg)
    lines = []
    trainer = Trainer(cfg, log=lines.append)
    loss = trainer.train_one_epoch(1)
    assert np.isfinite(loss) and trainer.niter_per_ep >= 1
    (said,) = [line for line in lines if line.startswith("DataLoader(")]
    native = cfg.dataset in ("audioset", "audioset_wav") or (
        cfg.dataset == "fsd50k" and cfg.load_lms)
    assert ("C++ Native" in said) == native
    assert ("one log-mel per batch" in said) == (not cfg.load_lms)
