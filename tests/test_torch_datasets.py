"""The port's on-disk datasets (ssl_audio_tpu_torch/data/datasets.py) and
get_train_dataset / _ConcatDataset against the JAX package's, on tiny trees
written here in the layouts the JAX package's own tests and tools write:
from the same tree and seed, the same items and labels bit for bit.  With
--load_wav (the log-mel of each item made from its wav) the items agree
within 1e-4: the port's plain log-mel against JAX's GEMM frontend, fp32
sums in another order.  Also the reference quirks the port keeps (the
AudioSet fallback, a header row in dev.csv)."""
import csv
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.data import datasets as JD
from ssl_audio_tpu.train import loop as jloop
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k
from ssl_audio_tpu_torch.train import loop
from tests.test_audioset_wav import fabricate_audioset
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

LOAD_WAV_TOL = 1e-4     # normalised log-mels: fp32 DFT / mel sums in another order
SR = 16000


def write_npy_tree(root, rng):
    """AudioSet `.npy`, LibriSpeech and NSynth trees beside the FSD50K one."""
    aset = os.path.join(root, "audioset_lms")
    os.makedirs(os.path.join(aset, "unbalanced_train_segments"))
    os.makedirs(os.path.join(aset, "eval_segments"))
    with open(os.path.join(aset, "class_labels_indices.csv"), "w") as f:
        f.write("index,mids,display_name\n")
        for i in range(4):
            f.write(f"{i},/m/{i},c{i}\n")
    for csv_name, sub, n in (("unbalanced_train_segments-downloaded.csv",
                              "unbalanced_train_segments", 6),
                             ("eval_segments-downloaded.csv", "eval_segments", 3)):
        with open(os.path.join(aset, csv_name), "w") as f:
            for i in range(n):
                f.write(f"y{i},/m/{i % 4}#/m/{(i + 1) % 4}\n")
                np.save(os.path.join(aset, sub, f"y{i}.npy"),
                        rng.standard_normal((64, 80 + 17 * i)).astype(np.float32))
    libri = os.path.join(root, "LibriSpeech_lms")
    os.makedirs(os.path.join(libri, "train-clean-100/19"))
    names = [f"train-clean-100/19/s{i}.flac" for i in range(5)]
    with open(os.path.join(libri, "librispeech_tr960_cut.json"), "w") as f:
        json.dump({"data": [{"wav": n} for n in names]}, f)
    for i, n in enumerate(names):
        np.save(os.path.join(libri, n[:-5] + ".npy"),
                rng.standard_normal((64, 60 + 40 * i)).astype(np.float32))


def write_nsynth_tree(root, hear, rng):
    base = os.path.join(hear, "tasks/nsynth_pitch-v2.2.3-50h")
    for split, n in (("train", 5), ("valid", 3), ("test", 3)):
        os.makedirs(os.path.join(base, f"16000/{split}"), exist_ok=True)
        out = os.path.join(root, f"nsynth_lms/nsynth-{split}/audio")
        os.makedirs(out, exist_ok=True)
        labels = {}
        for i in range(n):
            name = f"{split}_{i}.wav"
            labels[name] = [str(21 + 7 * i)]
            np.save(os.path.join(out, name[:-4] + ".npy"),
                    rng.standard_normal((64, 64 + 30 * i)).astype(np.float32))
            wavfile.write(os.path.join(base, f"16000/{split}", name), SR,
                          (rng.standard_normal(SR // 2 + 997 * i) * 2000).astype(np.int16))
        with open(os.path.join(base, f"{split}.json"), "w") as f:
            json.dump(labels, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("disk"))
    data = os.path.join(root, "data")
    rng = np.random.default_rng(0)
    fabricate_fsd50k(data, 8, (40, 300), seed=1, n_val=3, n_test=4, n_classes=6,
                     max_labels=3, wavs=True)
    write_npy_tree(data, rng)
    write_nsynth_tree(data, os.path.join(root, "hear"), rng)
    fabricate_audioset(data)
    return root


def configs(**kw):
    kw = {"batch_size": 4, **kw}
    return default_config(device="cpu", **kw), jax_config(**kw)


def assert_items_equal(port_ds, jax_ds, indices=None):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)) if indices is None else indices:
        (x, y), (jx, jy) = port_ds[i], jax_ds[i]
        assert x.dtype == jx.dtype and np.array_equal(x, jx), i
        assert np.asarray(y).dtype == np.asarray(jy).dtype and np.array_equal(y, jy), i


def build_pair(name, tree, cfg, jcfg, seed=5):
    data = os.path.join(tree, "data")
    hear = os.path.join(tree, "hear")
    fsd = dict(norm_stats=D.NORM_STATS["fsd50k"], data_dir=data, seed=seed)
    if name.startswith("fsd50k_"):
        split = name[len("fsd50k_"):]
        kw = dict(fsd, split=split, crop_frames=711 if split == "test" else None)
        return D.FSD50K(cfg, **kw), JD.FSD50K(jcfg, **kw)
    if name == "librispeech":
        kw = dict(norm_stats=D.NORM_STATS["librispeech"], data_dir=data, seed=seed)
        return D.LibriSpeech(cfg, **kw), JD.LibriSpeech(jcfg, **kw)
    if name.startswith("nsynth_"):
        kw = dict(split=name[len("nsynth_"):], norm_stats=D.NORM_STATS["nsynth"],
                  data_dir=data, hear_dir=hear, seed=seed)
        return D.NSynthHEAR(cfg, **kw), JD.NSynthHEAR(jcfg, **kw)
    if name.startswith("audioset_lms"):
        kw = dict(norm_stats=D.NORM_STATS["audioset"], data_dir=data, seed=seed,
                  test=name.endswith("test"))
        return D.AudioSet(cfg, **kw), JD.AudioSet(jcfg, **kw)
    if name.startswith("audioset_wav"):
        opts = {"audioset_wav": {}, "audioset_wav_balanced": {"balanced_only": True},
                "audioset_wav_test": {"test": True},
                "audioset_wav_cap": {"twohundredk_only": True, "cap": 4}}[name]
        kw = dict(base_dir=os.path.join(data, "audioset"), seed=seed, **opts)
        return D.AudioSetWav(cfg, **kw), JD.AudioSetWav(jcfg, **kw)
    if name == "wav_clips":
        kw = dict(wav_dir=os.path.join(data, "audioset"), clip_seconds=1.0, seed=seed)
        return D.WavClips(cfg, **kw), JD.WavClips(jcfg, **kw)
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "fsd50k_train", "fsd50k_val", "fsd50k_test", "fsd50k_train_val", "librispeech",
    "nsynth_train", "nsynth_valid", "audioset_lms", "audioset_lms_test", "audioset_wav",
    "audioset_wav_balanced", "audioset_wav_test", "audioset_wav_cap", "wav_clips"])
def test_items_equal_jax(tree, name):
    """Every item and label, bit for bit, the crops drawn in item order."""
    cfg, jcfg = configs()
    port_ds, jax_ds = build_pair(name, tree, cfg, jcfg)
    assert_items_equal(port_ds, jax_ds)
    assert getattr(port_ds, "label_num", None) == getattr(jax_ds, "label_num", None)
    for attr in ("supports_native", "returns_wav"):
        assert getattr(port_ds, attr, False) == getattr(jax_ds, attr, False), attr
    if hasattr(jax_ds, "batch_paths"):
        paths, labels = port_ds.batch_paths(np.arange(min(3, len(jax_ds))))
        jpaths, jlabels = jax_ds.batch_paths(np.arange(min(3, len(jax_ds))))
        assert paths == jpaths and np.array_equal(np.stack(labels), np.stack(jlabels))


@pytest.mark.parametrize("dataset,flags", [
    ("fsd50k", {}), ("fsd50k", {"pre_norm": True}), ("librispeech", {}),
    ("fsd50k+librispeech", {}), ("audioset", {}), ("audioset+librispeech", {}),
    ("audioset_wav", {}), ("audioset_wav", {"audioset_balanced_only": True}),
    ("audioset_wav", {"audioset_200k_only": True})])
def test_get_train_dataset_equals_jax(tree, dataset, flags, monkeypatch):
    """The training set of each dataset (the concatenated ones through
    _ConcatDataset) from the same tree: its length, label size and items."""
    monkeypatch.chdir(tree)
    cfg, jcfg = configs(dataset=dataset, seed=3, **flags)
    port_ds = loop.get_train_dataset(cfg, "data")
    jax_ds = jloop.get_train_dataset(jcfg, "data")
    assert type(port_ds).__name__ == type(jax_ds).__name__
    assert getattr(port_ds, "label_num", None) == getattr(jax_ds, "label_num", None)
    assert_items_equal(port_ds, jax_ds)


def test_nsynth_and_cifar10_in_get_train_dataset(tree, monkeypatch):
    """nsynth reads its HEAR json under hear/ of the working directory, as
    in JAX; cifar10 is not ported."""
    monkeypatch.chdir(tree)
    cfg, jcfg = configs(dataset="nsynth")
    assert_items_equal(loop.get_train_dataset(cfg), jloop.get_train_dataset(jcfg))
    with pytest.raises(NotImplementedError):
        loop.get_train_dataset(cfg.replace(dataset="cifar10"))


@pytest.mark.parametrize("name", ["fsd50k_train", "fsd50k_test", "nsynth_train"])
def test_load_wav_items_match_jax(tree, name):
    """--load_wav: the wav crop, the log-mel, the frame crop and the
    normalisation of each item against JAX's _to_lms_from_wav path, within
    LOAD_WAV_TOL, the same draws in the same order; and load_batch (one
    log-mel for the batch) against the same items made one by one."""
    cfg, jcfg = configs(load_lms=False, crop_frames=64)
    port_ds, jax_ds = build_pair(name, tree, cfg, jcfg)
    assert port_ds.mel_per_batch and not port_ds.supports_native
    for i in range(len(jax_ds)):
        (x, y), (jx, jy) = port_ds[i], jax_ds[i]
        assert x.shape == jx.shape == (1, 64, 64 if name != "fsd50k_test" else 711)
        np.testing.assert_allclose(x, jx, atol=LOAD_WAV_TOL, rtol=0)
        assert np.array_equal(y, jy)
    batch_ds, jax_ds = build_pair(name, tree, cfg, jcfg, seed=9)
    xs, ys = batch_ds.load_batch(np.arange(len(jax_ds)))
    for i in range(len(jax_ds)):
        jx, jy = jax_ds[i]
        np.testing.assert_allclose(xs[i], jx, atol=LOAD_WAV_TOL, rtol=0)
        assert np.array_equal(ys[i], jy)
    assert batch_ds.rng.bit_generator.state == jax_ds.rng.bit_generator.state


def test_load_wav_runs_where_the_config_says(tree):
    """The log-mel of --load_wav runs on cfg.device: None is the card, and
    without one the item raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg, _ = configs(load_lms=False)
    ds = D.FSD50K(cfg.replace(device=None), split="train", data_dir=os.path.join(tree, "data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds[0]


def test_audioset_corrupt_file_falls_back_to_fsd50k(tree, tmp_path):
    """An unreadable AudioSet `.npy` is replaced by a random FSD50K dev clip
    drawn from the dataset's generator, as in JAX; without FSD50K it
    raises."""
    import shutil

    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(tree, "data"), data)
    with open(os.path.join(data, "audioset_lms/unbalanced_train_segments/y2.npy"), "wb") as f:
        f.write(b"not a numpy file")
    os.remove(os.path.join(data, "audioset_lms/unbalanced_train_segments/y4.npy"))
    cfg, jcfg = configs()
    kw = dict(norm_stats=D.NORM_STATS["audioset"], data_dir=data, seed=2)
    port_ds, jax_ds = D.AudioSet(cfg, **kw), JD.AudioSet(jcfg, **kw)
    assert_items_equal(port_ds, jax_ds)
    shutil.rmtree(os.path.join(data, "FSD50K"))
    port_ds = D.AudioSet(cfg, **kw)
    assert port_ds.files_fsd50k == []
    port_ds[0]
    with pytest.raises(ValueError):
        port_ds[2]
    with pytest.raises(FileNotFoundError):
        port_ds[4]


def test_fsd50k_header_row_is_an_item_as_in_jax(tree, tmp_path):
    """Quirk kept from the JAX package: FSD50K reads dev.csv with no header
    handling, so the published files' header row (fname,labels,mids,split)
    becomes a clip of the train_val split, whose label 'mids' is no class:
    both packages raise KeyError on it.  The train and val splits filter it
    out by the split column."""
    import shutil

    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(tree, "data", "FSD50K"), os.path.join(data, "FSD50K"))
    shutil.copytree(os.path.join(tree, "data", "FSD50K_lms"), os.path.join(data, "FSD50K_lms"))
    dev = os.path.join(data, "FSD50K/FSD50K.ground_truth/dev.csv")
    rows = list(csv.reader(open(dev)))
    with open(dev, "w", newline="") as f:
        csv.writer(f).writerows([["fname", "labels", "mids", "split"]] + rows)
    cfg, jcfg = configs()
    for split in ("train", "val", "train_val"):
        kw = dict(split=split, data_dir=data)
        port_ds, jax_ds = D.FSD50K(cfg, **kw), JD.FSD50K(jcfg, **kw)
        assert port_ds.files == jax_ds.files
        assert ("fname" in port_ds.files) == (split == "train_val")
    with pytest.raises(KeyError):
        port_ds.batch_paths([0])
    with pytest.raises(KeyError):
        jax_ds.batch_paths([0])


def test_audioset_wav_rejects_another_sample_rate(tree):
    """A wav not at cfg.sample_rate raises ValueError (the JAX item asserts)."""
    cfg, _ = configs(sample_rate=32000)
    ds = D.AudioSetWav(cfg, base_dir=os.path.join(tree, "data/audioset"))
    with pytest.raises(ValueError, match="32000"):
        ds[0]


def test_crop_or_pad_and_unit_crop_equal_jax():
    """The crop helpers draw what JAX's draw, from the same generator state."""
    rng = np.random.default_rng(4)
    for length in (50, 96, 97, 300):
        lms = rng.standard_normal((1, 64, length)).astype(np.float32)
        a, b = np.random.default_rng(length), np.random.default_rng(length)
        assert np.array_equal(D.crop_or_pad(lms, 96, a), JD.crop_or_pad(lms, 96, b))
        assert a.bit_generator.state == b.bit_generator.state
