"""The port's C++ batch readers (ssl_audio_tpu_torch/data/native_loader.py,
built from the repository's native/*.cc into build/native/) and its
DataLoader (data/pipeline.py) against the JAX package's: the same paths and
seed give the same bits; a whole epoch of the port's loader equals the JAX
loader's on the native path and on the Python path (one thread, where the
shared item generator draws in item order).  A failed build raises.  The
pinned-slot path needs a card and skips here; chip_smoke.py phase 10 runs
it."""
import os
import shutil
import time

import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.data import datasets as JD
from ssl_audio_tpu.data import native_loader as jnative
from ssl_audio_tpu.data.pipeline import DataLoader as JaxDataLoader
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data import native_loader as native
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_audioset_wav, fabricate_fsd50k
from tests.test_torch_datasets import write_npy_tree
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

LOAD_WAV_TOL = 1e-4     # as tests/test_torch_datasets.py


def load_jax_readers(attempts: int = 40) -> None:
    """Load the JAX package's two C++ readers in this process before a test
    compares against them.  JAX builds them with g++ in place under native/
    on first use, so in a fresh checkout a worker can load a library while
    another worker's g++ is still writing it: get_lib then returns None,
    and the JAX loader would quietly take its Python path.  Once loaded, a
    library stays cached for the process."""
    for _ in range(attempts):
        if jnative.get_lib() is not None and jnative.get_wav_lib() is not None:
            return
        time.sleep(0.5)
    raise RuntimeError("the JAX package's native readers do not build")


@pytest.fixture(scope="module", autouse=True)
def jax_readers():
    load_jax_readers()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native"))
    fabricate_fsd50k(root, 13, (40, 400), seed=2, n_val=3, n_test=5, n_classes=7,
                     max_labels=2, wavs=True)
    fabricate_audioset_wav(root, 9, seconds=1.0, seed=3, n_balanced=3, n_eval=2,
                           stereo_every=3, short_every=4, short_seconds=(0.4, 0.7))
    write_npy_tree(root, np.random.default_rng(4))
    # an f8 log-mel beside the f4 ones
    np.save(os.path.join(root, "FSD50K_lms/FSD50K.dev_audio/f0.npy"),
            np.random.default_rng(5).standard_normal((64, 120)))
    return root


def configs(**kw):
    kw = {"batch_size": 4, **kw}
    return default_config(device="cpu", **kw), jax_config(**kw)


def test_npy_reader_bit_identical_to_jax(data):
    cfg, jcfg = configs()
    ds = D.FSD50K(cfg, split="train_val", data_dir=data)
    paths, _ = ds.batch_paths(np.arange(len(ds)))
    for crop in (96, 711):
        reader = native.NativeBatchReader(64, crop, -4.95, 5.855, n_threads=3)
        jreader = jnative.NativeBatchReader(64, crop, -4.95, 5.855, n_threads=3)
        for seed in (0, 7, 1_000_003 * 3 + 131 + 2):
            got = reader.read(paths, seed=seed)
            assert got.shape == (len(paths), 1, 64, crop)
            assert np.array_equal(got, jreader.read(paths, seed=seed))


def test_wav_reader_bit_identical_to_jax(data):
    cfg, _ = configs(dataset="audioset_wav")
    for opts in ({}, {"balanced_only": True}, {"test": True}):
        ds = D.AudioSetWav(cfg, base_dir=os.path.join(data, "audioset"), **opts)
        paths, _ = ds.batch_paths(range(len(ds)))
        reader = native.NativeWavReader(ds.unit_length, 16000, n_threads=2)
        jreader = jnative.NativeWavReader(ds.unit_length, 16000, n_threads=2)
        for seed in (0, 11):
            got = reader.read(paths, seed=seed)
            assert got.shape == (len(paths), ds.unit_length)
            assert np.array_equal(got, jreader.read(paths, seed=seed))


def test_readers_write_into_the_callers_buffer_and_raise_ioerror(data):
    cfg, _ = configs()
    paths, _ = D.FSD50K(cfg, split="train", data_dir=data).batch_paths(range(4))
    reader = native.NativeBatchReader(64, 96, 0.0, 1.0)
    out = np.full((4, 1, 64, 96), np.nan, np.float32)
    assert reader.read(paths, seed=5, out=out) is out
    assert np.array_equal(out, reader.read(paths, seed=5))
    with pytest.raises(ValueError, match="float32"):
        reader.read(paths, out=np.empty((4, 1, 64, 95), np.float32))
    with pytest.raises(IOError, match="missing.npy"):
        reader.read(paths[:2] + [os.path.join(data, "missing.npy")])
    wav_reader = native.NativeWavReader(15200, 32000)
    wav_ds = D.AudioSetWav(cfg, base_dir=os.path.join(data, "audioset"))
    with pytest.raises(IOError, match="failed on"):
        wav_reader.read(wav_ds.batch_paths(range(2))[0])


def test_libraries_build_under_build_native_keyed_by_source_and_flags():
    for source in native.SIGNATURES:
        path = native.library_path(source)
        assert path.parent == native.REPO / "build" / "native"
        assert path.name.startswith(source[:-3] + "-") and path.suffix == ".so"
        native.load(source)
        assert path.is_file()
    # the port's own copies of the JAX side's readers, byte for byte
    assert native.NATIVE_SRC == native.REPO / "ssl_audio_tpu_torch" / "csrc"
    for source in native.SIGNATURES:
        assert (native.NATIVE_SRC / source).read_bytes() == \
            (native.REPO / "native" / source).read_bytes()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a missing compiler, or one that fails, raises
    RuntimeError with its output, and nothing is left in the build
    directory."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.NativeBatchReader(64, 96, 0.0, 1.0)
    src = tmp_path / "native"
    src.mkdir()
    (src / "npy_batch_loader.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", src)
    monkeypatch.setattr(native, "CXX", "g++")
    with pytest.raises(RuntimeError, match="error"):
        native.load("npy_batch_loader.cc")
    assert list((tmp_path / "build").iterdir()) == []


def epochs(port_loader, jax_loader, epochs=(1, 2)):
    for epoch in epochs:
        port_loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = list(port_loader), list(jax_loader)
        assert len(got) == len(want) == len(port_loader) == len(jax_loader)
        for (x, y), (jx, jy) in zip(got, want):
            assert isinstance(x, np.ndarray) and x.dtype == jx.dtype
            assert np.array_equal(x, jx) and np.array_equal(y, jy)


def fsd50k_pair(data, cfg, jcfg, **kw):
    kw = dict(split="train_val", norm_stats=D.NORM_STATS["fsd50k"], data_dir=data, seed=4, **kw)
    return D.FSD50K(cfg, **kw), JD.FSD50K(jcfg, **kw)


@pytest.mark.parametrize("name", ["fsd50k", "fsd50k_eval", "audioset_wav", "audioset_lms"])
def test_native_epochs_equal_jax(data, name):
    """The C++ path: whole epochs, shuffled by the epoch and seeded per batch,
    ragged last batch (drop_last False) included."""
    cfg, jcfg = configs()
    loader_kw = dict(batch_size=4, num_workers=3, seed=6)
    if name == "fsd50k":
        ds, jds = fsd50k_pair(data, cfg, jcfg)
    elif name == "fsd50k_eval":
        ds, jds = fsd50k_pair(data, cfg, jcfg, crop_frames=711)
        loader_kw.update(shuffle=False, drop_last=False)
    elif name == "audioset_wav":
        kw = dict(base_dir=os.path.join(data, "audioset"), seed=1)
        ds, jds = D.AudioSetWav(cfg, **kw), JD.AudioSetWav(jcfg, **kw)
    else:
        kw = dict(norm_stats=D.NORM_STATS["audioset"], data_dir=data, seed=1)
        ds, jds = D.AudioSet(cfg, **kw), JD.AudioSet(jcfg, **kw)
    lines = []
    loader = DataLoader(ds, log=lines.append, **loader_kw)
    epochs(loader, JaxDataLoader(jds, **loader_kw))
    assert len(lines) == 1 and "C++ Native" in lines[0] and "host arrays" in lines[0]


@pytest.mark.parametrize("name", ["fsd50k_transform", "librispeech", "fsd50k+librispeech"])
def test_python_path_epochs_equal_jax_at_one_thread(data, name):
    """Datasets without the C++ path (a transform, no batch_paths, a
    concatenation): each item on the Python path, in item order on one
    thread."""
    from ssl_audio_tpu.train.loop import _ConcatDataset as JaxConcat
    from ssl_audio_tpu_torch.train.loop import _ConcatDataset

    cfg, jcfg = configs()
    # as many dummy labels as FSD50K's classes, so mixed batches stack
    libri_kw = dict(norm_stats=D.NORM_STATS["librispeech"], data_dir=data, seed=2, n_dummy=7)
    if name == "fsd50k_transform":
        ds, jds = fsd50k_pair(data, cfg, jcfg, transform=lambda x: 2.0 * x)
    elif name == "librispeech":
        ds, jds = D.LibriSpeech(cfg, **libri_kw), JD.LibriSpeech(jcfg, **libri_kw)
    else:
        fsd, jfsd = fsd50k_pair(data, cfg, jcfg)
        ds = _ConcatDataset([fsd, D.LibriSpeech(cfg, **libri_kw)])
        jds = JaxConcat([jfsd, JD.LibriSpeech(jcfg, **libri_kw)])
    lines = []
    loader = DataLoader(ds, batch_size=4, num_workers=1, seed=8, log=lines.append)
    epochs(loader, JaxDataLoader(jds, batch_size=4, num_workers=1, seed=8))
    assert lines == [f"DataLoader({type(ds).__name__}): items on 1 Python threads; host arrays"]


def test_an_unreadable_file_remakes_its_batch_on_the_python_path(data, tmp_path):
    """A corrupt AudioSet `.npy` fails the C++ read of its batch; that batch
    is made again item by item, where AudioSet replaces the file by a random
    FSD50K clip, as the JAX loader does."""
    root = str(tmp_path / "data")
    shutil.copytree(data, root)
    with open(os.path.join(root, "audioset_lms/unbalanced_train_segments/y3.npy"), "wb") as f:
        f.write(b"broken")
    cfg, jcfg = configs()
    kw = dict(norm_stats=D.NORM_STATS["audioset"], data_dir=root, seed=1)
    loader_kw = dict(batch_size=2, num_workers=1, seed=3)
    epochs(DataLoader(D.AudioSet(cfg, **kw), log=lambda line: None, **loader_kw),
           JaxDataLoader(JD.AudioSet(jcfg, **kw), **loader_kw))


def test_load_wav_batches_match_jax(data):
    """--load_wav: one log-mel launch per batch (load_batch) against the JAX
    loader's items on one thread, within LOAD_WAV_TOL; the dataset's
    generator ends where JAX's does."""
    cfg, jcfg = configs(load_lms=False, crop_frames=64)
    ds, jds = fsd50k_pair(data, cfg, jcfg)
    lines = []
    loader = DataLoader(ds, batch_size=4, num_workers=3, seed=2, log=lines.append)
    jloader = JaxDataLoader(jds, batch_size=4, num_workers=1, seed=2)
    assert loader._native_reader() is None and jloader._native_reader() is None
    for (x, y), (jx, jy) in zip(list(loader), list(jloader)):
        np.testing.assert_allclose(x, jx, atol=LOAD_WAV_TOL, rtol=0)
        assert np.array_equal(y, jy)
    assert ds.rng.bit_generator.state == jds.rng.bit_generator.state
    assert "one log-mel per batch" in lines[0]


def test_an_item_error_reaches_the_consumer(data, tmp_path):
    cfg, _ = configs()
    ds = D.LibriSpeech(cfg, data_dir=data)
    ds.data[2]["wav"] = "gone/x.flac"
    with pytest.raises(FileNotFoundError):
        list(DataLoader(ds, batch_size=2, num_workers=2, log=lambda line: None))


@pytest.mark.cuda
def test_pinned_batches_on_the_card(data):
    """Given a CUDA device the loader gives pinned tensors from its ring,
    the C++ reader writing into them; copied with non_blocking=True behind
    queued device work, every batch equals the host path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory and events")
    dev = torch.device("cuda")
    cfg, _ = configs()
    ds = fsd50k_pair(data, cfg, configs()[1])[0]
    got = []
    for x, _ in DataLoader(ds, batch_size=2, num_workers=2, seed=1, device=dev, prefetch=1,
                           log=lambda line: None):
        assert x.is_pinned()
        torch.cuda._sleep(20_000_000)
        got.append(x.to(dev, non_blocking=True))
    want = [x for x, _ in DataLoader(ds, batch_size=2, num_workers=2, seed=1,
                                     log=lambda line: None)]
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), w)
