"""HEAR serving of the ResNets (ssl_audio_tpu_torch/hear/conv.py with
resnet18, resnet18_ReGP_NRF, resnet50 and resnet50_ReGP_NRF) against the
JAX package's wrapper (ssl_audio_tpu/hear/conv.py) on the same
reference-layout .pth (written by the JAX package's export_resnet_state_dict
from seeded variables): timestamp and scene embeddings in fp32 and with
compute_dtype="bfloat16", and the reference `.pth` rule both importers
follow: a file with tensors the importer does not read loads (AudioNTT2022
too), a file that lacks one it needs raises KeyError in both.

Both packages' timestamp chunks are cut to CHUNK windows (the pipelines'
BATCH_SIZE): the embeddings do not depend on it (the statistics run over
all real windows), and a ResNet-50 over 512 windows a chunk would cost the
suite minutes.  JAX's random init, which the .pth overwrites, is replaced by
zeros of its shapes for the same reason.

Tolerances: fp32 embeddings within EMB_RTOL of their largest value (fp32
through a deep conv stack, summed in other orders); bf16 as in
tests/test_torch_bf16_serving.py (hold: at most twice JAX's own
bf16-to-fp32 gap, and 2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssl_audio_tpu.hear.conv as jconv
import ssl_audio_tpu.hear.vit as jhvit
from ssl_audio_tpu.models import resnet as jresnet
from ssl_audio_tpu.utils.torch_export import export_audiontt_state_dict, export_resnet_state_dict
from ssl_audio_tpu_torch.hear import conv as tconv
from ssl_audio_tpu_torch.hear import pipeline
from ssl_audio_tpu_torch.models import resnet
from tests.test_torch_bf16_serving import hold
from tests.test_torch_resnet import seeded_variables

EMB_RTOL = 1e-4
CHUNK = 32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_chunks_and_no_jax_init():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jhvit, jconv, pipeline, tconv):
            mp.setattr(mod, "BATCH_SIZE", CHUNK)
        real_init = jresnet.ResNet.init

        def zeros_init(self, rngs, *args, **kwargs):
            tree = jax.eval_shape(lambda: real_init(self, rngs, *args, **kwargs))
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)

        mp.setattr(jresnet.ResNet, "init", zeros_init)
        yield


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (0.3 * rng.standard_normal((2, 24000))).astype(np.float32)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """model type -> a reference-layout .pth of seeded weights and
    statistics."""
    root = tmp_path_factory.mktemp("pth")
    out = {}
    for i, mt in enumerate(resnet.MODEL_TYPES):
        variables = seeded_variables(mt, {}, (1, 1, 64, 96), np.random.default_rng(i))
        out[mt] = str(root / f"{mt}.pth")
        torch.save(export_resnet_state_dict(variables, mt), out[mt])
    return out


def close_emb(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=0, atol=EMB_RTOL * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("model_type", resnet.MODEL_TYPES)
def test_resnet_embeddings_match_jax(model_type, pth, audio, small_chunks_and_no_jax_init):
    """Timestamp (2 x 31 windows in chunks of CHUNK) and scene embeddings
    (T = 151, odd) of each ResNet type, fp32 and bf16, from the same .pth;
    fused_conv / pool_reorder are accepted and change nothing."""
    jm = jconv.load_model(pth[model_type], model_type)
    tm = tconv.load_model(pth[model_type], model_type, fused_conv=True, pool_reorder=True,
                          device="cpu")
    dim = resnet.FACTORIES[model_type]().embed_dim
    assert tm.scene_embedding_size == tm.timestamp_embedding_size == jm.embed_dim == dim
    jts, jstamps = jconv.get_timestamp_embeddings(audio, jm)
    ts, stamps = tconv.get_timestamp_embeddings(torch.from_numpy(audio), tm)
    assert ts.shape == (2, 31, dim) and ts.dtype == torch.float32
    np.testing.assert_array_equal(stamps.numpy(), jstamps.numpy())
    close_emb(ts, jts.numpy(), "timestamp")
    jscene = jconv.get_scene_embeddings(audio, jm).numpy()
    close_emb(tconv.get_scene_embeddings(audio, tm), jscene, "scene")

    jb = jconv.load_model(pth[model_type], model_type, compute_dtype="bfloat16")
    tb = tconv.load_model(pth[model_type], model_type, compute_dtype="bfloat16", device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tb.model.parameters())
    assert all(b.dtype == torch.float32 for b in tb.model.buffers() if b.is_floating_point())
    hold(tconv.get_timestamp_embeddings(audio, tb)[0], jconv.get_timestamp_embeddings(audio, jb)[0],
         jts, f"{model_type} bf16 timestamp")
    hold(tconv.get_scene_embeddings(audio, tb), jconv.get_scene_embeddings(audio, jb),
         jscene, f"{model_type} bf16 scene")


def test_seeded_resnet_init_is_the_training_init():
    """load_model("", resnet type) draws the port's ResNet init from a
    generator seeded with 0, as JAX's wrapper inits with key 0."""
    tm = tconv.load_model("", "resnet18", device="cpu")
    ref = resnet.init_resnet_weights_(resnet.resnet18(), torch.Generator().manual_seed(0))
    for k, v in ref.state_dict().items():
        assert torch.equal(tm.model.state_dict()[k], v), k


def test_extra_tensors_are_ignored_and_missing_ones_raise(pth, audio, tmp_path,
                                                          small_chunks_and_no_jax_init):
    """The reference .pth rule (JAX utils/torch_import.py): a file with a
    tensor the importer does not read loads into both packages, for
    AudioNTT2022 (fc.9.weight) and a ResNet (fc.weight, a classifier the
    encoder has no use for), with the same embeddings; a file that lacks a
    tensor the importer needs raises KeyError in both."""
    audiontt_sd = export_audiontt_state_dict(jconv.load_model("", "audiontt").variables)
    sd = dict(audiontt_sd)
    sd["fc.9.weight"] = torch.ones(3, 3)
    path = str(tmp_path / "audiontt_extra.pth")
    torch.save(sd, path)
    jm = jconv.load_model(path, "audiontt")
    tm = tconv.load_model(path, "audiontt", device="cpu")
    close_emb(tconv.get_scene_embeddings(audio, tm), jconv.get_scene_embeddings(audio, jm).numpy(),
              "audiontt with an extra tensor")

    sd = torch.load(pth["resnet18"], weights_only=True)
    sd["fc.weight"] = torch.ones(10, 512)
    path = str(tmp_path / "resnet18_extra.pth")
    torch.save(sd, path)
    jm = jconv.load_model(path, "resnet18")
    tm = tconv.load_model(path, "resnet18", device="cpu")
    close_emb(tconv.get_scene_embeddings(audio, tm), jconv.get_scene_embeddings(audio, jm).numpy(),
              "resnet18 with an extra tensor")

    for mt, drop in (("audiontt", "features.4.weight"), ("resnet18", "layer2.0.bn1.running_var")):
        sd = dict(audiontt_sd) if mt == "audiontt" else torch.load(pth[mt], weights_only=True)
        del sd[drop]
        path = str(tmp_path / f"{mt}_missing.pth")
        torch.save(sd, path)
        with pytest.raises(KeyError):
            jconv.load_model(path, mt)
        with pytest.raises(KeyError, match=drop):
            tconv.load_model(path, mt, device="cpu")


def test_resnet_d_file_loads_as_in_jax(pth, audio, tmp_path, small_chunks_and_no_jax_init):
    """A ResNet-D layout (a projection's conv at downsample.1, its BN at
    downsample.2) loads into the plain ResNet's downsample.{0,1} in both
    packages; a tensor of the wrong shape raises in the port."""
    plain = torch.load(pth["resnet18"], weights_only=True)
    sd = {}
    for k, v in plain.items():
        if ".downsample." in k:
            i = int(k.split(".downsample.")[1][0])
            k = k.replace(f".downsample.{i}.", f".downsample.{i + 1}.")
        sd[k] = v
    path = str(tmp_path / "resnet18_d.pth")
    torch.save(sd, path)
    jm = jconv.load_model(path, "resnet18")
    tm = tconv.load_model(path, "resnet18", device="cpu")
    ref = tconv.load_model(pth["resnet18"], "resnet18", device="cpu")
    for k, v in ref.model.state_dict().items():
        assert torch.equal(tm.model.state_dict()[k], v), k
    close_emb(tconv.get_scene_embeddings(audio, tm), jconv.get_scene_embeddings(audio, jm).numpy(),
              "ResNet-D layout")
    sd = torch.load(pth["resnet18"], weights_only=True)
    sd["layer1.0.conv1.weight"] = sd["layer1.0.conv1.weight"][:, :32]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="layer1.0.conv1.weight"):
        tconv.load_model(path, "resnet18", device="cpu")
