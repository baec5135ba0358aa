"""The port's HEAR API (ssl_audio_tpu_torch/hear/conv.py) against the JAX
package's (ssl_audio_tpu/hear/conv.py) on a few short seeded clips, with the
same weights: scene embeddings (batched and ragged), timestamp embeddings and
their timestamps, the reference's 1/N statistics quirk, fetch_dtype, config
loading without PyYAML, a reference-layout .pth loaded by both packages, and
no silent fallback to the CPU."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import ssl_audio_tpu.hear.conv as jconv
import ssl_audio_tpu.hear.utils as jutils
from ssl_audio_tpu.utils.torch_export import export_audiontt_state_dict
from ssl_audio_tpu_torch.hear import conv as tconv
from ssl_audio_tpu_torch.hear import pipeline
from ssl_audio_tpu_torch.hear import utils as tutils
from ssl_audio_tpu_torch.utils.weights import audiontt_state_dict_from_jax
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

# embeddings / max|embedding|: fp32 through the frontend and four layers,
# summed in different orders by XLA and PyTorch's CPU kernels
EMB_RTOL = 1e-5


def _perturbed(variables, seed=1):
    v = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(seed)
    for i in range(2):
        bn = v["params"]["encoder"][f"BatchNorm_{i}"]
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        bn["scale"] = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
        bn["scale"][:16] *= -1.0
        bn["bias"] = (0.2 * rng.standard_normal(64)).astype(np.float32)
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def models():
    jm = jconv.load_model("", "audiontt")
    jm.variables = _perturbed(jm.variables)
    tm = tconv.load_model("", "audiontt", fused_conv=True, device="cpu")
    tm.model.load_state_dict(audiontt_state_dict_from_jax(jm.variables), strict=True)
    return jm, tm


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (0.3 * rng.standard_normal((2, 24000))).astype(np.float32)


@pytest.fixture(scope="module")
def timestamp_ref(models, audio):
    emb, ts = jconv.get_timestamp_embeddings(audio, models[0])
    return emb.numpy(), ts.numpy()


def assert_close_emb(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=EMB_RTOL * float(np.abs(ref).max()))


def test_metadata(models):
    tm = models[1]
    assert tm.scene_embedding_size == tm.timestamp_embedding_size == 3072
    assert tm.sample_rate == 16000 and tm.device == torch.device("cpu")


def test_timestamp_embeddings_match_jax(models, audio, timestamp_ref):
    emb, ts = tconv.get_timestamp_embeddings(torch.from_numpy(audio), models[1])
    assert emb.dtype == torch.float32 and emb.shape == (2, 31, 3072)
    np.testing.assert_array_equal(ts.numpy(), timestamp_ref[1])
    assert_close_emb(emb, timestamp_ref[0])


def test_fetch_dtype_bfloat16(models, audio):
    tm = models[1]
    ref, _ = tconv.get_timestamp_embeddings(audio, tm)
    tm.fetch_dtype = "bfloat16"
    try:
        emb, _ = tconv.get_timestamp_embeddings(audio, tm)
    finally:
        tm.fetch_dtype = "float32"
    assert emb.dtype == torch.float32
    torch.testing.assert_close(emb, ref.to(torch.bfloat16).float(), rtol=0, atol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_scene_embeddings_match_jax(models, audio, ragged):
    clips = [audio[0], audio[1][:20000]] if ragged else audio
    ref = jconv.get_scene_embeddings(clips, models[0]).numpy()
    out = tconv.get_scene_embeddings(clips, models[1])
    assert out.shape == (2, 3072)
    assert_close_emb(out, ref)


def test_timestamp_stats_quirk():
    """The pipeline normalises with mean = mu / N and std = sqrt(unbiased
    var) / N over the real rows only (zero padding rows excluded)."""
    rng = np.random.default_rng(3)
    N, seen = 5, []
    flat = torch.zeros(pipeline.BATCH_SIZE, 8)
    flat[:N] = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))

    def to_feature(rows):
        return (rows[:, None, None, :] * 3.0 + 1.0)

    def encode(m):
        seen.append(m.clone())
        return m.reshape(len(m), -1)

    out = pipeline.timestamp_pipeline(to_feature, encode, flat, N)
    mel = flat[:N].double().numpy() * 3.0 + 1.0
    mean = mel.mean() / N
    std = mel.std(ddof=1) / N
    ref = (mel - mean) / std
    # fp32 normalisation of float64 statistics: a few ulp of the largest value
    np.testing.assert_allclose(seen[0].reshape(N, -1).numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert out.shape == (N, 8)
    assert tutils.compute_timestamp_stats(mel) == pytest.approx(
        jutils.compute_timestamp_stats(mel))


def test_framing_matches_jax(audio):
    frames, ts = tutils.frame_audio(audio, 15200, 50, 16000)
    jf, jts = jutils.frame_audio(audio, 15200, 50, 16000)
    np.testing.assert_array_equal(frames, jf)
    np.testing.assert_array_equal(ts, jts)
    flat, dts, N = pipeline.frame_audio_on_device(audio, 15200, 50, 16000,
                                                  torch.device("cpu"))
    assert N == 2 * 31 and flat.shape == (pipeline.BATCH_SIZE, 15200)
    np.testing.assert_array_equal(flat[:N].numpy(), frames.reshape(N, -1))
    assert not flat[N:].any()
    np.testing.assert_array_equal(dts.numpy(), ts)


def test_reference_pth_loads_into_both(models, audio, tmp_path):
    """A reference-layout .pth (torch_export + torch.save) gives the same
    embeddings in both packages."""
    path = str(tmp_path / "audiontt.pth")
    torch.save(export_audiontt_state_dict(models[0].variables), path)
    jm = jconv.load_model(path, "audiontt")
    tm = tconv.load_model(path, "audiontt", device="cpu")
    assert_close_emb(tconv.get_scene_embeddings(audio, tm),
                     jconv.get_scene_embeddings(audio, jm).numpy())


def test_config_without_yaml(tmp_path):
    path = Path(__file__).resolve().parents[1] / "ssl_audio_tpu" / "hear" / "config.yaml"
    ref = yaml.safe_load(path.read_text())
    assert tutils.load_config(str(path)) == ref
    assert tutils.DEFAULT_CONFIG == ref
    assert tutils.load_config("no/such/file.yaml") == ref
    cfg = tmp_path / "c.yaml"
    cfg.write_text("# frontend\nwin_length: 1024   # full window\nf_max: 8000.0\n")
    got = tutils.load_config(str(cfg))
    assert got.win_length == 1024 and got.f_max == 8000.0 and got.n_mels == 64
    cfg.write_text("not a key value line\n")
    with pytest.raises(ValueError):
        tutils.load_config(str(cfg))


def test_no_silent_cpu_and_unported_options():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tconv.load_model()
    with pytest.raises(ValueError):         # bfloat16 is ported; other types are not
        tconv.load_model(compute_dtype="float16", device="cpu")
    with pytest.raises(NotImplementedError):     # not a HEAR conv model type, in JAX either
        tconv.load_model(model_type="resnet34", device="cpu")
    with pytest.raises(NotImplementedError):
        tconv.load_model("checkpoints/orbax_dir", device="cpu")


def test_load_model_takes_the_jax_arguments_in_their_order():
    """load_model and ConvModelWrapper take the JAX package's arguments in
    its positions (pool_reorder before compute_dtype), then `device`: a
    positional call binds each argument where JAX binds it."""
    import inspect

    for jfn, tfn in ((jconv.load_model, tconv.load_model),
                     (jconv.ConvModelWrapper.__init__, tconv.ConvModelWrapper.__init__)):
        jnames = list(inspect.signature(jfn).parameters)
        tnames = list(inspect.signature(tfn).parameters)
        assert tnames == jnames + ["device"], (jfn.__qualname__, jnames, tnames)


def test_pool_reorder_gives_the_same_embeddings(audio):
    """pool_reorder selects the JAX package's eval order only: the port's
    embeddings are the same with it on and off."""
    out = []
    for reorder in (False, True):
        tm = tconv.load_model("", "audiontt", "hear/config.yaml", False, "float32", True,
                              reorder, device="cpu")
        assert tm.pool_reorder is reorder and tm.compute_dtype == "float32"
        out.append(tconv.get_scene_embeddings(audio, tm))
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)
