"""The port's offline converter (ssl_audio_tpu_torch/tools/wav_to_lms.py,
--device cpu: the plain log-mel) against the JAX package's
tools/wav_to_lms.py on a small tree of wavs of three lengths, mono and
stereo, one longer than --batch_seconds: the same `.npy` files at the same
relative paths, within 1e-4 (fp32 DFT and mel sums in another order)."""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from ssl_audio_tpu_torch.tools import wav_to_lms
from tools import wav_to_lms as jax_wav_to_lms
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4
SR = 16000


@pytest.fixture
def wav_dir(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "wavs"
    for i, (rel, seconds, channels) in enumerate([
            ("a.wav", 0.5, 1), ("b.wav", 0.5, 2), ("sub/c.wav", 0.8, 1),
            ("sub/d.wav", 0.8, 1), ("sub/deeper/e.wav", 1.3, 1), ("f.WAV", 0.5, 1)]):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        n = int(seconds * SR)
        wavfile.write(str(path), SR, (rng.standard_normal((n, channels) if channels > 1 else n)
                                      * 3000).astype(np.int16))
    (root / "notes.txt").write_text("not a wav")
    return root


def outputs(out_dir):
    return {os.path.relpath(os.path.join(r, f), out_dir): np.load(os.path.join(r, f))
            for r, _d, fs in os.walk(out_dir) for f in fs}


def test_converter_matches_jax(wav_dir, tmp_path, capsys):
    flags = ["--in_dir", str(wav_dir), "--batch_size", "2", "--workers", "2",
             "--batch_seconds", "1.0"]
    rec = wav_to_lms.main(flags + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_wav_to_lms.main(flags + ["--out_dir", str(tmp_path / "jax")])
    got, want = outputs(tmp_path / "port"), outputs(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["a.npy", "b.npy", "f.npy", "sub/c.npy", "sub/d.npy",
                                          "sub/deeper/e.npy"]
    for name, lms in got.items():
        assert lms.dtype == want[name].dtype == np.float32
        assert lms.shape == want[name].shape, name
        np.testing.assert_allclose(lms, want[name], atol=TOL, rtol=0, err_msg=name)
    assert got["sub/deeper/e.npy"].shape == (64, 1 + SR // 160)   # cut to --batch_seconds
    # lengths 8000 (a, b, f: a group of 2 and one of 1), 12800 (c, d), 16000 (e)
    assert rec["files"] == 6 and rec["groups"] == 4 and rec["device"] == "cpu"
    assert "4 log-mel launches" in capsys.readouterr().out


def test_converter_runs_on_the_card_unless_asked(wav_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wav_to_lms.main(["--in_dir", str(wav_dir), "--out_dir", str(tmp_path / "o")])
