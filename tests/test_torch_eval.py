"""The port's evaluation stack (ssl_audio_tpu_torch/eval/ and the ViT's
visualisation methods) against the JAX package's on the same seeded numpy
inputs and the same weights (vit_state_dict_from_jax,
audiontt_state_dict_from_jax, mlp_clf_params_from_jax): the unit splitter
in both branches, with T dividing the unit and not; forward_viz,
forward_attn and get_intermediate_layers at depth 2; make_embedding_forward
for AudioNTT2022 and vit_tiny; extract_embeddings over the synthetic
loader; the MLP probe from a shared start; low-shot subsets; the kNN
monitor; the statistics against scikit-learn (which the port does not
import); the deferred options.

Tolerances: fp32 paths within 1e-4 of max|ref| (sums in other orders; flax's
one-pass LayerNorm variance).  The probe: a few epochs from the same start
and the same numpy batch order hold the weights to 1e-4 of each tensor's
largest value (Adam amplifies rounding over long fits, so those are compared
on their score)."""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

import ssl_audio_tpu.config as jconfig
import ssl_audio_tpu.data.datasets as jdatasets
import ssl_audio_tpu.data.pipeline as jpipeline
import ssl_audio_tpu.eval.encode as jencode
import ssl_audio_tpu.eval.knn as jknn
import ssl_audio_tpu.eval.linear as jlinear
import ssl_audio_tpu.eval.low_shot as jlow_shot
import ssl_audio_tpu.eval.mlp_clf as jmlp
import ssl_audio_tpu.eval.stats as jstats
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu_torch import config as tconfig
from ssl_audio_tpu_torch.data.datasets import SyntheticLMS
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.eval import encode, knn, linear, low_shot, mlp_clf, stats
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train.state import build_encoder
from ssl_audio_tpu_torch.utils.weights import (
    audiontt_state_dict_from_jax, mlp_clf_params_from_jax, vit_state_dict_from_jax)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
SPEC = dict(img_size=(64, 96), patch_size=(16, 16), embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)


def close(a, b, what="", tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, float(np.abs(b).max())),
                               err_msg=what)


def perturbed(variables, seed=1):
    v = jax.tree.map(np.array, dict(variables))
    rng = np.random.default_rng(seed)
    v["params"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    return v


@pytest.fixture(scope="module")
def vit_pair():
    """A depth-2 width-64 MAE ViT with decoder: (JAX module, variables, port)."""
    jmodel = jvit.MaskedAutoencoderViT(jvit.ViTSpec(**SPEC, use_decoder=True))
    key = jax.random.key(0)
    variables = perturbed(jmodel.init({"params": key, "mask": key}, jnp.zeros((2, 1, 64, 96)),
                                      mask_ratio=0.5, masked_recon=True, train=False))
    model = vit.MaskedAutoencoderViT(vit.ViTSpec(**SPEC, use_decoder=True))
    model.load_state_dict(vit_state_dict_from_jax(variables["params"], None, model.spec),
                          strict=True)
    return jmodel, variables, model.eval()


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def apply_fns(vit_pair):
    """The same unit forward in both packages: (JAX apply_fn, port apply_fn)."""
    jmodel, variables, model = vit_pair

    def japply(xu, return_all):
        return jmodel.apply(variables, xu, train=False, return_all=return_all)

    def tapply(xu, return_all):
        with torch.no_grad():
            return model(xu, return_all=return_all)

    return japply, tapply


# ---------------------------------------------------------------- encode.py

@pytest.mark.parametrize("T", [50, 96, 100, 192])
def test_pad_to_unit_multiple(T):
    x = images((2, 1, 4, T))
    got = encode.pad_to_unit_multiple(torch.from_numpy(x), 96)
    want = np.asarray(jencode.pad_to_unit_multiple(jnp.asarray(x), 96))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[-1] == (T // 96 + 1) * 96            # a whole unit when T divides


@pytest.mark.parametrize("use_cls", [True, False])
@pytest.mark.parametrize("T", [192, 150])
def test_encode_vit_matches_jax(vit_pair, use_cls, T):
    """T = 192 divides the unit (the silent unit's CLS in the mean; no rows
    removed from the dense mean); T = 150 pads 42 frames (dense: 3 padded
    token columns of 8 removed)."""
    japply, tapply = apply_fns(vit_pair)
    x = images((3, 1, 64, T), seed=T)
    kw = dict(unit_frames=96, use_cls=use_cls, patch_fbins=4, embed_d=64)
    want = np.asarray(jencode.encode_vit(japply, jnp.asarray(x), **kw))
    got = encode.encode_vit(tapply, torch.from_numpy(x), **kw)
    assert got.shape == ((3, 64) if use_cls else (3, 4 * 64))
    close(got, want, f"use_cls={use_cls}, T={T}")


@pytest.mark.parametrize("T", [96, 192, 150])
def test_encode_lms_units_matches_jax(vit_pair, T):
    japply, tapply = apply_fns(vit_pair)
    x = images((3, 1, 64, T), seed=T + 1)
    want = np.asarray(jencode.encode_lms_units(japply, jnp.asarray(x), 96))
    got = encode.encode_lms_units(tapply, torch.from_numpy(x), 96)
    assert got.shape == (3, T // 96 + 1, 64)
    close(got, want, f"T={T}")


def test_silent_unit_is_one_batch_1_forward(vit_pair):
    """The silent unit (raw zeros) is forwarded once at batch 1 and
    broadcast: per clip, its embedding is the last unit's, and equal to a
    zero unit forwarded with the clips."""
    _, tapply = apply_fns(vit_pair)
    batches = []

    def counting(xu, return_all):
        batches.append(xu.shape[0])
        return tapply(xu, return_all)

    x = torch.from_numpy(images((3, 1, 64, 96)))
    units = encode.encode_lms_units(counting, x, 96)
    assert batches == [3, 1]
    zero = tapply(torch.zeros(1, 1, 64, 96), False)[0]
    for b in range(3):
        torch.testing.assert_close(units[b, -1], zero, rtol=0, atol=0)
    with_zero = tapply(torch.cat([x, torch.zeros(1, 1, 64, 96)]), False)
    torch.testing.assert_close(units[0, -1], with_zero[-1], rtol=0, atol=1e-5)
    batches.clear()
    cls = encode.encode_vit(counting, x, 96, use_cls=True, patch_fbins=4, embed_d=64)
    assert batches == [3, 1]
    torch.testing.assert_close(cls, units.mean(dim=1), rtol=0, atol=1e-6)


def test_extract_embeddings_over_the_synthetic_loader():
    """extract_embeddings over the port's SyntheticLMS / DataLoader against the
    JAX package's over its own, with the identity flattened as the forward:
    the same items, order and targets."""
    tcfg = tconfig.default_config(dataset="synthetic", crop_frames=32)
    jcfg = jconfig.default_config(dataset="synthetic", crop_frames=32)
    tl = DataLoader(SyntheticLMS(tcfg, length=21, n_classes=3), batch_size=8, shuffle=False,
                    drop_last=False, num_workers=2)
    jl = jpipeline.DataLoader(jdatasets.SyntheticLMS(jcfg, length=21, n_classes=3),
                              batch_size=8, shuffle=False, drop_last=False, num_workers=2)
    X, Y = encode.extract_embeddings(lambda x: x.flatten(1) * 2.0, tl, "cpu")
    JX, JY = jencode.extract_embeddings(lambda x: x.reshape(x.shape[0], -1) * 2.0, jl)
    assert X.shape == (21, 64 * 32) and Y.shape == (21, 3)
    np.testing.assert_array_equal(X, JX)
    np.testing.assert_array_equal(Y, JY)
    if not torch.cuda.is_available():          # device None = the card, never the CPU
        with pytest.raises(RuntimeError):
            encode.extract_embeddings(lambda x: x, tl)


# ---------------------------------------------------------------- models/vit.py

def test_unpatchify_inverts_patchify(vit_pair):
    _, _, model = vit_pair
    x = torch.from_numpy(images((2, 1, 64, 96)))
    patches = model.patchify(x)
    assert patches.shape == (2, 24, 256)
    torch.testing.assert_close(model.unpatchify(patches), x, rtol=0, atol=0)


def test_forward_viz_matches_jax(vit_pair, monkeypatch):
    """The same mask in both (the JAX draw replaced by the test's mask)."""
    jmodel, variables, model = vit_pair
    x = images((2, 1, 64, 96), seed=3)
    mask = (np.random.default_rng(4).random((2, 24)) < 0.75).astype(np.float32)
    monkeypatch.setattr(jvit, "random_token_mask", lambda rng, B, L, r: jnp.asarray(mask))
    want = jmodel.apply(variables, jnp.asarray(x), 0.75, method=jmodel.forward_viz,
                        rngs={"mask": jax.random.key(1)})
    with torch.no_grad():
        got = model.forward_viz(torch.from_numpy(x), mask=torch.from_numpy(mask))
    for name, g, w in zip(("loss", "recons", "errormap", "mask"), got, want):
        close(g, np.asarray(w), name)
    visible = np.repeat(np.repeat((1 - mask).reshape(2, 4, 6), 16, 1), 16, 2)[:, None] > 0
    np.testing.assert_array_equal(got[1].numpy()[visible], x[visible])


def test_forward_attn_matches_jax(vit_pair):
    jmodel, variables, model = vit_pair
    x = images((2, 1, 64, 96), seed=5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.forward_attn))
    with torch.no_grad():
        got = model.forward_attn(torch.from_numpy(x))
    assert got.shape == (2, 2, 4, 25, 25)
    close(got, want, "attention maps")
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 2, 4, 25), rtol=0, atol=1e-5)


def test_get_intermediate_layers_matches_jax(vit_pair):
    jmodel, variables, model = vit_pair
    x = images((2, 1, 64, 96), seed=6)
    want = jmodel.apply(variables, jnp.asarray(x), method=jmodel.get_intermediate_layers)
    with torch.no_grad():
        got = model.get_intermediate_layers(torch.from_numpy(x))
        last = model(torch.from_numpy(x), return_all=True)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, np.asarray(w), f"block {i}")
    torch.testing.assert_close(got[-1], last, rtol=0, atol=0)


# ---------------------------------------------------------------- linear.py

@pytest.fixture(scope="module")
def audiontt_pair():
    v = jax.tree.map(np.array, JaxAudioNTT2022().init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)), train=False))
    rng = np.random.default_rng(1)
    for i in range(2):
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    cfg = tconfig.default_config(dataset="synthetic")
    enc, _ = build_encoder(cfg)
    enc.load_state_dict(audiontt_state_dict_from_jax(v), strict=True)
    return v, enc


def test_make_embedding_forward_audiontt(audiontt_pair):
    """The pooled forward in eval mode (running statistics, the fused block
    1's eval path); the encoder's train mode is put back."""
    v, enc = audiontt_pair
    jcfg = jconfig.default_config(dataset="synthetic")
    jfwd = jlinear.make_embedding_forward(
        jcfg, types.SimpleNamespace(encoder=JaxAudioNTT2022()),
        {"encoder": v["params"]}, {"encoder": v["batch_stats"]})
    enc.train()
    fwd = linear.make_embedding_forward(tconfig.default_config(dataset="synthetic"), enc)
    x = images((3, 1, 64, 96), seed=8)
    got = fwd(torch.from_numpy(x))
    assert enc.training and not got.requires_grad and got.shape == (3, 3072)
    close(got, np.asarray(jfwd(jnp.asarray(x))), "AudioNTT2022 embeddings")


@pytest.fixture(scope="module")
def vit_tiny_pair():
    jenc = jvit.get_mae_vit("tiny", [16, 16], False)
    v = perturbed(jenc.init({"params": jax.random.key(0)}, jnp.zeros((1, 1, 64, 96)),
                            train=False))
    enc, _ = build_encoder(tconfig.default_config(dataset="synthetic", model_type="vit_tiny"))
    enc.load_state_dict(vit_state_dict_from_jax(v["params"], None, enc.spec), strict=True)
    return jenc, v, enc


@pytest.mark.parametrize("use_cls", [True, False])
def test_make_embedding_forward_vit(vit_tiny_pair, use_cls):
    """vit_tiny: units of cfg.crop_frames (96) frames, the CLS mean or the
    dense-token mean; the loader's 96-frame crops are one unit plus the
    silent one, a 150-frame input pads."""
    jenc, v, enc = vit_tiny_pair
    jcfg = jconfig.default_config(dataset="synthetic", model_type="vit_tiny", use_cls=use_cls)
    tcfg = tconfig.default_config(dataset="synthetic", model_type="vit_tiny", use_cls=use_cls)
    jfwd = jlinear.make_embedding_forward(jcfg, types.SimpleNamespace(encoder=jenc),
                                          {"encoder": v["params"]}, {})
    fwd = linear.make_embedding_forward(tcfg, enc)
    for T in (96, 150):
        x = images((2, 1, 64, T), seed=T)
        got = fwd(torch.from_numpy(x))
        assert got.shape == (2, 192 if use_cls else 4 * 192)
        close(got, np.asarray(jfwd(jnp.asarray(x))), f"use_cls={use_cls}, T={T}")


def test_eval_linear_on_the_synthetic_loader(audiontt_pair):
    """Embeddings of three class-structured loaders, the probe and the
    low-shot protocol, end to end on the CPU."""
    _, enc = audiontt_pair
    cfg = tconfig.default_config(dataset="synthetic")

    def loader(seed, n):
        return DataLoader(SyntheticLMS(cfg, length=n, n_classes=4, seed=seed), batch_size=16,
                          shuffle=False, drop_last=False, num_workers=2)

    res = linear.eval_linear(linear.make_embedding_forward(cfg, enc), loader(0, 64),
                             loader(1, 24), loader(2, 24), max_iter=5, device="cpu")
    assert res["score_all"] > 0.5                          # mAP, chance ~0.25
    assert len(res["score_5"]) == 2 and 0.0 <= res["score_5"][0] <= 1.0


def test_deferred_eval_options_raise(audiontt_pair, tmp_path, monkeypatch):
    """No eval option is deferred any more: --use_fp16_eval (held against
    JAX in tests/test_torch_bf16_serving.py) gives fp32 embeddings, and the
    per-epoch FSD50K probe of a BYOL state also scores its target encoder,
    without the low-shot protocol, as "teacher_score_all": eval_linear's
    score over the target (eval_linear is recorded here, not run: the
    forwards it was handed are checked against the two encoders).  Without
    FSD50K the probe's loaders raise FileNotFoundError (main then disables
    the hook)."""
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k

    _, enc = audiontt_pair
    cfg = tconfig.config_from_args(["--dataset", "synthetic", "--use_fp16_eval"])
    assert tconfig.unsupported_settings(cfg) == []
    tconfig.require_supported(cfg)
    emb = linear.make_embedding_forward(cfg, enc)(torch.zeros(2, 1, 64, 96))
    assert emb.dtype == torch.float32 and emb.shape == (2, 3072)
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    cfg = tconfig.default_config(dataset="fsd50k", device="cpu")
    with pytest.raises(FileNotFoundError):
        linear.get_fsd50k_eval_loaders(cfg, data_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        linear.make_epoch_eval_fn(cfg, data_dir=str(tmp_path / "none"))
    fabricate_fsd50k(str(tmp_path / "data"), 2, 50, n_val=1, n_test=1)
    eval_fn = linear.make_epoch_eval_fn(cfg, data_dir=str(tmp_path / "data"))
    target, _ = build_encoder(cfg)
    byol = types.SimpleNamespace(modules=torch.nn.ModuleDict(
        {"encoder": enc, "target": torch.nn.ModuleDict({"encoder": target})}))
    calls = []

    def eval_linear(forward, *loaders, low_shot=True, device=None):
        calls.append((forward, len(loaders), low_shot, device))
        return {"score_all": 0.25 * len(calls), **({"score_5": (0.1, 0.0)} if low_shot else {})}

    monkeypatch.setattr(linear, "eval_linear", eval_linear)
    scores = eval_fn(byol, 1)
    assert scores == {"score_all": 0.25, "score_5": (0.1, 0.0), "teacher_score_all": 0.5}
    assert [c[1:] for c in calls] == [(3, True, torch.device("cpu")),
                                      (3, False, torch.device("cpu"))]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, 64, 96))
                         .astype(np.float32))
    for (forward, *_), module in zip(calls, (enc, target)):
        assert torch.equal(forward(x), linear.make_embedding_forward(cfg, module)(x))
    assert not torch.equal(calls[0][0](x), calls[1][0](x))


# ---------------------------------------------------------------- mlp_clf.py

def blobs(rng, n_per_class, n_classes, d, spread=0.5):
    X, y = [], []
    for c in range(n_classes):
        X.append(rng.standard_normal(d) + spread * rng.standard_normal((n_per_class, d)))
        y.append(np.full(n_per_class, c))
    return np.concatenate(X).astype(np.float32), np.concatenate(y)


@pytest.mark.parametrize("multi_label", [False, True])
def test_mlp_classifier_matches_jax_from_the_same_start(multi_label):
    """A 3-epoch fit (an internal validation split, batches of 200 and a
    ragged last one, L2 1e-3): weights, best validation score and test
    score against the JAX probe started from the same parameters."""
    rng = np.random.default_rng(0)
    X, y = blobs(rng, 120, 4, 16)
    if multi_label:
        Y = np.eye(4, dtype=np.float32)[y]
        y = np.concatenate([Y, Y[:, :2]], axis=1)
    idx = rng.permutation(len(X))
    tr, te = idx[:420], idx[420:]
    kw = dict(hidden_layer_sizes=(32,), max_iter=3, alpha=1e-3, random_state=3)
    jclf = jmlp.MLPClassifier(**kw).fit(X[tr], y[tr])
    start = jmlp._init_mlp(jax.random.key(3), [16, 32, y.shape[1] if multi_label else 4])
    clf = mlp_clf.MLPClassifier(**kw, device="cpu").fit(
        X[tr], y[tr], init_params=mlp_clf_params_from_jax(start))
    assert clf.multi_label == multi_label
    for k, want in mlp_clf_params_from_jax(jclf.params).items():
        close(clf.params[k], want.numpy(), k)
    assert clf.best_val == pytest.approx(jclf.best_val, abs=1e-6)
    assert clf.score(X[te], y[te]) == pytest.approx(jclf.score(X[te], y[te]), abs=1e-6)
    np.testing.assert_allclose(clf.predict_proba(X[te]), jclf.predict_proba(X[te]),
                               rtol=0, atol=TOL)


def test_mlp_classifier_own_start_is_seeded():
    rng = np.random.default_rng(1)
    X, y = blobs(rng, 30, 3, 8)
    a = mlp_clf.MLPClassifier(hidden_layer_sizes=(8,), max_iter=2, device="cpu").fit(X, y)
    b = mlp_clf.MLPClassifier(hidden_layer_sizes=(8,), max_iter=2, random_state=0,
                              device="cpu").fit(X, y)
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mlp_clf.MLPClassifier()


def test_early_stopping_restores_the_best_parameters(monkeypatch):
    """A scripted validation curve through both packages' bookkeeping: the
    same number of epochs (val >= best resets the wait to 1), and the port
    ends on the parameters of its best epoch."""
    curve = [0.5, 0.7, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    rng = np.random.default_rng(2)
    X, y = blobs(rng, 20, 3, 8)
    kw = dict(hidden_layer_sizes=(8,), max_iter=len(curve), early_stopping=True,
              n_iter_no_change=2)
    jcalls, calls, snapshots = [], [], []
    monkeypatch.setattr(jmlp.MLPClassifier, "_metric_value",
                        lambda self, *a: (jcalls.append(1), curve[len(jcalls) - 1])[1])
    jclf = jmlp.MLPClassifier(**kw).fit(X, y)

    def scripted(self, *a):
        snapshots.append({k: v.clone() for k, v in self.net.state_dict().items()})
        calls.append(1)
        return curve[len(calls) - 1]

    monkeypatch.setattr(mlp_clf.MLPClassifier, "_metric_value", scripted)
    clf = mlp_clf.MLPClassifier(**kw, device="cpu").fit(X, y)
    assert len(calls) == len(jcalls) == 4 and clf.best_val == jclf.best_val == 0.7
    for k, v in clf.net.state_dict().items():
        torch.testing.assert_close(v, snapshots[1][k], rtol=0, atol=0)
        assert not torch.equal(v, snapshots[-1][k])


# ---------------------------------------------------------------- low_shot.py

@pytest.mark.parametrize("multi_label", [False, True])
def test_low_shot_subsets_match_jax(multi_label):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 4, 60)
    y = np.eye(4, dtype=np.float32)[labels] if multi_label else labels
    if multi_label:
        y[rng.random(60) < 0.3, 0] = 1.0                   # a second label on some clips
    got = low_shot.low_shot_subsets(y, 3)
    for g, w in zip(got, jlow_shot.low_shot_subsets(y, 3)):
        np.testing.assert_array_equal(g, w)
    s1, s2, s3 = map(set, got)
    if multi_label:
        # a clip of two classes may fill one class's first subset and another's second
        for s in (s1, s2, s3):
            assert (y[sorted(s)].sum(0) >= 3).all()
    else:                                                  # disjoint, n per class
        assert not (s1 & s2 or s2 & s3 or s1 & s3)
        for s in (s1, s2, s3):
            assert (np.bincount(y[sorted(s)], minlength=4) == 3).all()


# ---------------------------------------------------------------- knn.py

def test_knn_predict_matches_jax():
    """Random float features (no tied similarities), k below and above the
    bank size."""
    rng = np.random.default_rng(4)
    feats, bank = rng.standard_normal((6, 8)), rng.standard_normal((40, 8))
    labels = rng.integers(0, 3, 40)
    for k in (5, 200):
        want = np.asarray(jknn.knn_predict(
            jnp.asarray(feats, jnp.float32), jnp.asarray(bank, jnp.float32),
            jnp.asarray(labels, jnp.int32), 3, k))
        got = knn.knn_predict(torch.from_numpy(feats).float(), torch.from_numpy(bank).float(),
                              torch.from_numpy(labels), 3, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_eval_knn_matches_jax():
    rng = np.random.default_rng(5)
    X, y = blobs(rng, 30, 3, 8, spread=0.3)

    def loader(X, y, bs=16):
        return [(X[i : i + bs], y[i : i + bs]) for i in range(0, len(X), bs)]

    want = jknn.eval_knn(lambda x: x, loader(X, y), loader(X[::3], y[::3]), 3, k=10)
    got = knn.eval_knn(lambda x: x, loader(X, y), loader(X[::3], y[::3]), 3, k=10,
                       device="cpu")
    assert got == pytest.approx(want) and got[0] > 90.0


def test_knn_map_matches_jax():
    rng = np.random.default_rng(6)
    feats, bank = rng.standard_normal((20, 8)), rng.standard_normal((50, 8))
    labels = (rng.random((20, 5)) < 0.3).astype(np.float32)
    labels[:, 4] = 0.0                                     # a class with no positive
    bank_labels = (rng.random((50, 5)) < 0.3).astype(np.float32)
    for k in (7, 200):
        assert knn.knn_map(feats, labels, bank, bank_labels, k) == pytest.approx(
            jknn.knn_map(feats, labels, bank, bank_labels, k), abs=1e-12)


# ---------------------------------------------------------------- stats.py

@pytest.mark.parametrize("decimals", [0, 1, 4])
def test_average_precision_and_auc_match_sklearn(decimals):
    """Scores rounded to `decimals` places: ties at 0 and 1 decimals."""
    rng = np.random.default_rng(decimals)
    for _ in range(50):
        n = int(rng.integers(2, 60))
        t = (rng.random(n) < rng.random()).astype(np.float32)
        s = np.round(rng.standard_normal(n), decimals).astype(np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")                # no positive: sklearn warns, gives 0
            want = average_precision_score(t, s)
        assert stats.binary_average_precision(t, s) == pytest.approx(want, abs=1e-12)
        if 0 < t.sum() < n:
            assert stats.roc_auc(t, s) == pytest.approx(roc_auc_score(t, s), abs=1e-12)
    T = (rng.random((40, 6)) < 0.3).astype(np.float32)
    T[:, 2] = 0.0
    S = np.round(rng.standard_normal((40, 6)), decimals).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = average_precision_score(T, S)
    assert stats.average_precision(T, S) == pytest.approx(want, abs=1e-12)
    assert mlp_clf.average_precision(T, S) == pytest.approx(want, abs=1e-12)


def test_calculate_stats_matches_jax():
    rng = np.random.default_rng(7)
    target = (rng.random((64, 7)) < 0.3).astype(np.float32)
    target[:, 3], target[:, 5] = 0.0, 1.0                  # skipped: no positive, no negative
    output = rng.standard_normal((64, 7)).astype(np.float32)
    got, want = stats.calculate_stats(output, target), jstats.calculate_stats(output, target)
    assert [s["class"] for s in got] == [s["class"] for s in want] == [0, 1, 2, 4, 6]
    for g, w in zip(got, want):
        for key in ("AP", "auc", "d_prime"):
            assert g[key] == pytest.approx(w[key], abs=1e-12), key
    assert stats.mean_average_precision(output, target) == pytest.approx(
        jstats.mean_average_precision(output, target), abs=1e-12)
    assert stats.d_prime(0.5) == 0.0
