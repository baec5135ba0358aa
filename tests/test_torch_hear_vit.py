"""The port's HEAR API for the ViT family (ssl_audio_tpu_torch/hear/vit.py)
against the JAX package's (ssl_audio_tpu/hear/vit.py) on two seeded 2-s
clips, with the same weights: vit_tiny 16x16 and vitc_tiny 16x8 (the
default family; its ConvStem running statistics set away from 0 and 1),
every parameter moved off its initial value.  Timestamp embeddings and
timestamps (every 0.95-s window is one unit, so the silent unit enters each
mean), scene embeddings, the metadata, fetch_dtype="bfloat16", a
reference-layout .pth loaded by both packages, the options not ported yet,
and no silent fallback to the CPU.

Tolerance: embeddings within 1e-4 of max|ref| (fp32 through the frontend,
the 1/N-scaled inputs (~x82 here), 12 blocks and LayerNorm; XLA and
PyTorch's CPU kernels sum in other orders, and flax's LayerNorm takes
E[x^2] - E[x]^2 where PyTorch's is two-pass: measured ~2e-6)."""
import jax
import numpy as np
import pytest
import torch

import ssl_audio_tpu.hear.vit as jvit
from ssl_audio_tpu.utils.torch_export import export_vit_state_dict
from ssl_audio_tpu_torch.hear import vit as tvit
from ssl_audio_tpu_torch.utils.weights import vit_state_dict_from_jax


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch thread per test (tests/test_torch_checkpoint.py says why:
    under the suite's six workers a pool of threads per worker made this
    file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EMB_RTOL = 1e-4
BF16_RTOL = 2.0 ** -7     # one bf16 spacing: a value rounds to its neighbour on one side
MODELS = {"vit_tiny": ("vit_tiny", "16x16"), "vitc_tiny": ("vitc_tiny", "16x8")}


def _perturbed(variables, seed=1):
    v = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(seed)
    v["params"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    for st in v.get("batch_stats", {}).get("patch_embed", {}).values():
        c = st["mean"].shape[0]
        st["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
        st["var"] = (0.5 + rng.random(c)).astype(np.float32)
    return v


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    model_type, patch = MODELS[request.param]
    jm = jvit.load_model("", model_type, patch)
    jm.variables = _perturbed(jm.variables)
    tm = tvit.load_model("", model_type, patch, device="cpu")
    tm.model.load_state_dict(vit_state_dict_from_jax(
        jm.variables["params"], jm.variables.get("batch_stats"), tm.model.spec), strict=True)
    return request.param, jm, tm


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (0.3 * rng.standard_normal((2, 32000))).astype(np.float32)


def assert_close_emb(out, ref, rtol=EMB_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def test_metadata(models):
    name, jm, tm = models
    for attr in ("embed_dim", "scene_embedding_size", "timestamp_embedding_size",
                 "sample_rate", "use_cls"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    # the JAX wrapper's sizes as they are: timestamp embeddings are embed_dim
    # wide, the attribute says embed_dim * frequency patches
    assert tm.scene_embedding_size == 192 and tm.timestamp_embedding_size == 192 * 4
    assert tm.device == torch.device("cpu") and not tm.model.training
    assert tm.to("cuda") is tm and tm.eval() is tm and tm.model.training is False
    if name == "vitc_tiny":
        assert tm.model.grid_size() == (4, 12) and len(tm.model.blocks) == 11


def test_timestamp_embeddings_match_jax(models, audio):
    _, jm, tm = models
    ref, ref_ts = jvit.get_timestamp_embeddings(audio, jm)
    emb, ts = tvit.get_timestamp_embeddings(torch.from_numpy(audio), tm)
    assert emb.dtype == torch.float32 and emb.shape == (2, 41, 192)
    np.testing.assert_array_equal(ts.numpy(), ref_ts.numpy())
    assert_close_emb(emb, ref.numpy())


def test_scene_embeddings_match_jax(models, audio):
    _, jm, tm = models
    out = tvit.get_scene_embeddings(audio, tm)
    assert out.shape == (2, 192) and out.dtype == torch.float32
    assert_close_emb(out, jvit.get_scene_embeddings(audio, jm).numpy())


def test_scene_normalises_by_batch_statistics(models, audio):
    """One mean and one unbiased std over the whole batch of log-mels (not
    the conv wrapper's mean of per-clip statistics)."""
    _, _, tm = models
    lms = tm.to_feature(audio)
    want = tm.encode_lms((lms - lms.mean()) / lms.std(unbiased=True)).mean(dim=1)
    torch.testing.assert_close(tvit.get_scene_embeddings(audio, tm), want, rtol=0, atol=0)


def test_fetch_dtype_bfloat16(models, audio):
    _, jm, tm = models
    full, _ = tvit.get_timestamp_embeddings(audio, tm)
    jm.fetch_dtype = tm.fetch_dtype = "bfloat16"
    try:
        emb, _ = tvit.get_timestamp_embeddings(audio, tm)
        ref, _ = jvit.get_timestamp_embeddings(audio, jm)
    finally:
        jm.fetch_dtype = tm.fetch_dtype = "float32"
    assert emb.dtype == torch.float32
    torch.testing.assert_close(emb, full.to(torch.bfloat16).float(), rtol=0, atol=0)
    np.testing.assert_allclose(emb.numpy(), ref.numpy(), rtol=BF16_RTOL,
                               atol=EMB_RTOL * float(ref.abs().max()))


def test_reference_pth_loads_into_both(models, audio, tmp_path):
    """A reference-layout .pth (export_vit_state_dict + torch.save, the
    ConvStem's running statistics included; with MAE decoder weights beside
    the encoder's, which serving leaves out) gives the same embeddings in
    both packages."""
    name, jm, _ = models
    model_type, patch = MODELS[name]
    sd = export_vit_state_dict(jm.model, jm.variables["params"],
                               jm.variables.get("batch_stats"))
    sd["decoder_embed.weight"] = torch.zeros(8, 192)
    sd["mask_token"] = torch.zeros(1, 1, 8)
    path = str(tmp_path / f"{name}.pth")
    torch.save({"model": {f"encoder.{k}": v for k, v in sd.items()}}, path)
    jm2 = jvit.load_model(path, model_type, patch)
    tm2 = tvit.load_model(path, model_type, patch, device="cpu")
    assert_close_emb(tvit.get_scene_embeddings(audio, tm2),
                     jvit.get_scene_embeddings(audio, jm2).numpy())
    if name == "vitc_tiny":
        bn = tm2.model.patch_embed.proj[1]
        want = jm.variables["batch_stats"]["patch_embed"]["bn0"]
        np.testing.assert_array_equal(bn.running_mean.numpy(), want["mean"])
        np.testing.assert_array_equal(bn.running_var.numpy(), want["var"])


def test_random_weights_are_seeded():
    a = tvit.load_model("", "vit_tiny", "16x16", device="cpu")
    b = tvit.load_model("", "vit_tiny", "16x16", device="cpu")
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_no_silent_cpu_and_unported_options():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvit.load_model()
    with pytest.raises(ValueError):         # bfloat16 is ported; other types are not
        tvit.load_model(compute_dtype="float16", device="cpu")
    with pytest.raises(NotImplementedError):
        tvit.load_model("checkpoints/orbax_dir", "vit_tiny", "16x16", device="cpu")
    with pytest.raises(ValueError):
        tvit.load_model("", "vit_tiny", "16x16", fetch_dtype="float16", device="cpu")
    with pytest.raises(NotImplementedError):
        tvit.load_model("", "vit_huge", "16x16", device="cpu")
