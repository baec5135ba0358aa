"""The bf16 embedding paths of the port against the JAX package's, on the
CPU, with the same weights: make_embedding_forward under --use_fp16_eval
(AudioNTT2022 with the fused block 1's eval path, vit_tiny with CLS and
dense-token units), the HEAR wrappers with compute_dtype="bfloat16"
(AudioNTT2022 with fused_conv=True, vitc_tiny 16x8 with its ConvStem on
running statistics; timestamp and scene embeddings; fetch_dtype composed
with it), and the ViT's get_intermediate_layers and forward_attn on a bf16
model.  JAX runs its own bf16 mode (parameters and input cast to bf16,
batch statistics left fp32).  The ViTs are narrowed: both packages' "tiny"
size table patched to width 64, depth 3, 4 heads (the conv-stem variant
takes depth 2).

Tolerance, as in tests/test_torch_bf16_kernels.py: the port's bf16
embeddings may be no further from JAX's bf16 ones (relative L2) than
GAP_FACTOR times JAX's own bf16-to-fp32 gap on the same inputs, and no
further than EMB_CEIL.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssl_audio_tpu.config as jconfig
import ssl_audio_tpu.eval.linear as jlinear
import ssl_audio_tpu.hear.conv as jconv
import ssl_audio_tpu.hear.vit as jhvit
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu_torch import config as tconfig
from ssl_audio_tpu_torch.eval import linear
from ssl_audio_tpu_torch.hear import conv as tconv
from ssl_audio_tpu_torch.hear import vit as thvit
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.models.precision import cast_params_
from ssl_audio_tpu_torch.train.state import build_encoder
from ssl_audio_tpu_torch.utils.weights import (
    audiontt_state_dict_from_jax,
    vit_state_dict_from_jax,
)

GAP_FACTOR = 2.0
EMB_CEIL = 2e-2
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def hold(port16, jax16, jax32, what):
    port16, jax16, jax32 = (np.asarray(a.detach().float() if torch.is_tensor(a) else a,
                                       np.float64) for a in (port16, jax16, jax32))
    assert port16.shape == jax16.shape == jax32.shape, what
    gap, jgap = rel_l2(port16, jax16), rel_l2(jax16, jax32)
    print(f"{what}: port vs JAX bf16 {gap:.2e}; JAX bf16 vs fp32 {jgap:.2e}")
    assert gap <= GAP_FACTOR * jgap, f"{what}: {gap:.2e} > {GAP_FACTOR} x {jgap:.2e}"
    assert gap <= EMB_CEIL, f"{what}: {gap:.2e} > {EMB_CEIL}"


@pytest.fixture
def narrow_vits(monkeypatch):
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 3, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 3, 4)})


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


# ------------------------------------------------------ make_embedding_forward

def test_use_fp16_eval_audiontt_matches_jax():
    """The pooled forward in bf16 through the fused block 1's eval path (the
    port's default), running statistics fp32; the encoder is left fp32."""
    v = jax.tree.map(np.array, JaxAudioNTT2022().init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)), train=False))
    rng = np.random.default_rng(1)
    for i in range(2):
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    enc, _ = build_encoder(tconfig.default_config(dataset="synthetic"))
    enc.load_state_dict(audiontt_state_dict_from_jax(v), strict=True)
    x = images((3, 1, 64, 96), seed=8)
    want = {}
    for fp16 in (True, False):
        jcfg = jconfig.default_config(dataset="synthetic", use_fp16_eval=fp16)
        want[fp16] = np.asarray(jlinear.make_embedding_forward(
            jcfg, types.SimpleNamespace(encoder=JaxAudioNTT2022()),
            {"encoder": v["params"]}, {"encoder": v["batch_stats"]})(jnp.asarray(x)))
    cfg = tconfig.default_config(dataset="synthetic", use_fp16_eval=True)
    got = linear.make_embedding_forward(cfg, enc)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 3072)
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    hold(got, want[True], want[False], "AudioNTT2022 --use_fp16_eval")


@pytest.mark.parametrize("use_cls", [True, False])
def test_use_fp16_eval_vit_matches_jax(narrow_vits, use_cls):
    """vit_tiny units in bf16: CLS (96 frames: one unit and the silent one)
    and dense tokens (150 frames: padded)."""
    jenc = jvit.get_mae_vit("tiny", [16, 16], False)
    v = jenc.init({"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)), train=False)
    params = perturbed(v["params"])
    enc, _ = build_encoder(tconfig.default_config(dataset="synthetic", model_type="vit_tiny"))
    enc.load_state_dict(vit_state_dict_from_jax(params, None, enc.spec), strict=True)
    T = 96 if use_cls else 150
    x = images((2, 1, 64, T), seed=T)
    want = {}
    for fp16 in (True, False):
        jcfg = jconfig.default_config(dataset="synthetic", model_type="vit_tiny",
                                      use_cls=use_cls, use_fp16_eval=fp16)
        want[fp16] = np.asarray(jlinear.make_embedding_forward(
            jcfg, types.SimpleNamespace(encoder=jenc), {"encoder": params}, {})(jnp.asarray(x)))
    cfg = tconfig.default_config(dataset="synthetic", model_type="vit_tiny", use_cls=use_cls,
                                 use_fp16_eval=True)
    got = linear.make_embedding_forward(cfg, enc)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 64 if use_cls else 4 * 64)
    hold(got, want[True], want[False], f"vit_tiny --use_fp16_eval use_cls={use_cls}")


# ------------------------------------------------------------------------ HEAR

@pytest.fixture(scope="module")
def audio():
    return (0.3 * np.random.default_rng(7).standard_normal((2, 24000))).astype(np.float32)


@pytest.fixture(scope="module")
def conv_models():
    """JAX fp32, JAX bf16, and the port in bf16 with fused_conv=True, all on
    one set of weights (BN scales partly negative, running statistics off 0
    and 1)."""
    jm32 = jconv.load_model("", "audiontt")
    jm16 = jconv.load_model("", "audiontt", compute_dtype="bfloat16")
    v = jax.tree.map(np.array, jm32.variables)
    rng = np.random.default_rng(1)
    for i in range(2):
        bn = v["params"]["encoder"][f"BatchNorm_{i}"]
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        bn["scale"] = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
        bn["scale"][:16] *= -1.0
        bn["bias"] = (0.2 * rng.standard_normal(64)).astype(np.float32)
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    jm32.variables = v
    jm16.variables = dict(v, params=jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                                 v["params"]))
    tm = tconv.load_model("", "audiontt", fused_conv=True, compute_dtype="bfloat16",
                          device="cpu")
    sd = audiontt_state_dict_from_jax(v)
    tm.model.load_state_dict(sd, strict=True)
    return jm32, jm16, tm


def test_hear_conv_bf16_matches_jax(conv_models, audio):
    """Timestamp (the fused block's bf16 eval path) and scene (T = 1001 odd:
    the plain block in bf16) embeddings; parameters bf16 from the load on,
    running statistics fp32; fetch_dtype="bfloat16" rounds the bf16
    compute's fp32 embeddings."""
    jm32, jm16, tm = conv_models
    assert all(p.dtype == BF16 for p in tm.model.parameters())
    assert all(b.dtype != BF16 for b in tm.model.buffers())
    emb, ts = tconv.get_timestamp_embeddings(torch.from_numpy(audio), tm)
    assert emb.dtype == torch.float32 and emb.shape == (2, 31, 3072)
    hold(emb, jconv.get_timestamp_embeddings(audio, jm16)[0],
         jconv.get_timestamp_embeddings(audio, jm32)[0], "HEAR conv timestamp")
    scene = tconv.get_scene_embeddings(audio, tm)
    hold(scene, jconv.get_scene_embeddings(audio, jm16),
         jconv.get_scene_embeddings(audio, jm32), "HEAR conv scene")
    tm.fetch_dtype = "bfloat16"
    try:
        fetched, _ = tconv.get_timestamp_embeddings(torch.from_numpy(audio), tm)
    finally:
        tm.fetch_dtype = "float32"
    torch.testing.assert_close(fetched, emb.to(BF16).float(), rtol=0, atol=0)


def test_hear_vit_bf16_matches_jax(narrow_vits, audio):
    """vitc_tiny 16x8 (the HEAR default family: ConvStem with running
    statistics, einsum attention) in bf16: timestamp and scene embeddings;
    the ConvStem's statistics and the position table stay fp32."""
    jm32 = jhvit.load_model("", "vitc_tiny", "16x8")
    jm16 = jhvit.load_model("", "vitc_tiny", "16x8", compute_dtype="bfloat16")
    v = jax.tree.map(np.array, jm32.variables)
    v["params"] = perturbed(v["params"])
    rng = np.random.default_rng(2)
    for st in v["batch_stats"]["patch_embed"].values():
        c = st["mean"].shape[0]
        st["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
        st["var"] = (0.5 + rng.random(c)).astype(np.float32)
    jm32.variables = v
    jm16.variables = dict(v, params=jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                                 v["params"]))
    tm = thvit.load_model("", "vitc_tiny", "16x8", compute_dtype="bfloat16", device="cpu")
    tm.model.load_state_dict(vit_state_dict_from_jax(v["params"], v["batch_stats"],
                                                     tm.model.spec), strict=True)
    assert all(p.dtype == BF16 for p in tm.model.parameters())
    assert tm.model.pos_embed.dtype == torch.float32
    emb, _ = thvit.get_timestamp_embeddings(torch.from_numpy(audio), tm)
    assert emb.dtype == torch.float32 and emb.shape == (2, 31, 64)
    hold(emb, jhvit.get_timestamp_embeddings(audio, jm16)[0],
         jhvit.get_timestamp_embeddings(audio, jm32)[0], "HEAR vitc timestamp")
    hold(thvit.get_scene_embeddings(audio, tm), jhvit.get_scene_embeddings(audio, jm16),
         jhvit.get_scene_embeddings(audio, jm32), "HEAR vitc scene")


# ------------------------------------------------------- ViT methods under bf16

SPEC = dict(img_size=(64, 96), patch_size=(16, 16), embed_dim=64, depth=2, num_heads=4)


def test_vit_methods_under_bf16():
    """get_intermediate_layers and forward_attn of a model whose parameters
    are bf16, on a bf16 input, against the JAX module with bf16 parameters:
    bf16 tokens out of every block, fp32 attention maps (the softmax runs in
    fp32)."""
    jmodel = jvit.MaskedAutoencoderViT(jvit.ViTSpec(**SPEC))
    params = perturbed(jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)),
                                   train=False)["params"])
    model = vit.MaskedAutoencoderViT(vit.ViTSpec(**SPEC))
    model.load_state_dict(vit_state_dict_from_jax(params, None, model.spec), strict=True)
    cast_params_(model.eval(), BF16)
    x = images((2, 1, 64, 96), seed=6)
    for method in ("get_intermediate_layers", "forward_attn"):
        want = {}
        for dt in (jnp.bfloat16, jnp.float32):
            p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
            out = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=method))(
                p, jnp.asarray(x, dt))
            want[dt] = np.stack([np.asarray(o, np.float32) for o in out])
        with torch.no_grad():
            got = getattr(model, method)(torch.from_numpy(x).to(BF16))
        got = torch.stack(list(got)) if isinstance(got, list) else got
        assert got.dtype == (BF16 if method == "get_intermediate_layers" else torch.float32)
        hold(got, want[jnp.bfloat16], want[jnp.float32], method)
    # the mean pool of the unmasked tokens weighs them by an fp32 mask, as
    # JAX's does: an fp32 latent from bf16 tokens
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jmodel.apply({"params": p16}, jnp.asarray(x, jnp.bfloat16), mean_pool=True,
                        train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(BF16), mean_pool=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EMB_CEIL * float(np.abs(np.asarray(want)).max()))
