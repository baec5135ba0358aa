"""The supervised evaluation slice of the port (augment/spec_augment.py,
augment/mask_conv.py, eval/finetune.py train_classifier, and the evaluate
and extract_embeddings entry points) against the JAX package on the CPU.

SpecAugment's masks, mixup and mask_conv are held to JAX's bit for bit,
given the draws JAX's keys make.  train_classifier (AudioNTT2022 at
crop_frames 32, batch 4, SyntheticLMS batches) runs one epoch of two steps
with mixup and SpecAugment in both packages from the same encoder and head,
the draws replayed from JAX's key chain; dropout is taken out on both sides
(flax's Dropout patched to the identity, the port's keep masks 0.7, which
scale back to 1).  Tolerances: fp32 1e-4 (BASELINE.md) for the losses
(relative), the head, the running statistics and the val score; the
encoder's parameters as each one's change over the two steps (below,
CHANGE_TOL).  The entry points run as a user runs them, with --device
cpu, in this process (`run_cli`)."""
import runpy
import sys
import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssl_audio_tpu.eval.finetune as jfinetune
from ssl_audio_tpu.augment import mask_conv as jmask_conv
from ssl_audio_tpu.augment import spec_augment as jspec
from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu_torch.augment import spec_augment
from ssl_audio_tpu_torch.augment.mask_conv import mask_conv
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.data.datasets import SyntheticLMS
from ssl_audio_tpu_torch.eval import finetune
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.utils.weights import classifier_head_from_jax, encoder_state_dict_from_jax
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

B, FRAMES, CLASSES = 4, 32, 10
TOL = 1e-4
KW = dict(dataset="synthetic", model_type="audiontt", batch_size=B, crop_frames=FRAMES,
          projector_hidden_dim=64, synthetic_steps_per_epoch=2, num_workers=1, seed=0)


def lms(seed, shape=(B, 1, 64, FRAMES)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_band(key, max_width):
    """What jspec._axis_mask(key, B, size, max_width) draws: (width, u)."""
    k_w, k_s = jax.random.split(key)
    width = jax.random.randint(k_w, (B, 1), 0, max_width + 1)
    u = jax.random.uniform(k_s, (B, 1))
    return (torch.from_numpy(np.asarray(width)[:, 0].astype(np.int32)),
            torch.from_numpy(np.asarray(u)[:, 0]))


def jax_mixup(key, alpha):
    """What jspec.mixup_batch(key, ...) draws: (lambda, permutation)."""
    k_lam, k_perm = jax.random.split(key)
    return (float(jax.random.beta(k_lam, alpha, alpha, ())),
            torch.from_numpy(np.asarray(jax.random.permutation(k_perm, B))))


@pytest.mark.parametrize("axis", ["freq", "time"])
def test_masks_equal_jax(axis):
    x = lms(0)
    for seed in range(4):
        key = jax.random.key(seed)
        if axis == "freq":
            want = jspec.freq_mask(key, jnp.asarray(x))
            got = spec_augment.freq_mask(torch.from_numpy(x), jax_band(key, 8))
        else:
            want = jspec.time_mask(key, jnp.asarray(x))
            got = spec_augment.time_mask(torch.from_numpy(x), jax_band(key, 20))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn from a generator: one band per sample, at most max_width wide
    got = spec_augment.time_mask(torch.ones(64, 1, 2, FRAMES),
                                 gen=torch.Generator().manual_seed(0))
    zeroed = (got[:, 0, 0] == 0).sum(dim=1)
    assert int(zeroed.max()) <= 20 and bool((got[:, 0, 0] == got[:, 0, 1]).all())


def test_mixup_equals_jax():
    x, y = lms(1), np.eye(CLASSES, dtype=np.float32)[[0, 3, 5, 9]]
    for seed in range(4):
        key = jax.random.key(seed)
        jx, jy = jspec.mixup_batch(key, jnp.asarray(x), jnp.asarray(y), 0.2)
        tx, ty = spec_augment.mixup_batch(torch.from_numpy(x), torch.from_numpy(y), 0.2,
                                          draws=jax_mixup(key, 0.2))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # drawn from a generator: lambda ~ Beta(0.2, 0.2) (mean 1/2, most mass near
    # 0 and 1), a permutation
    gen = torch.Generator().manual_seed(0)
    lams = np.array([spec_augment.draw_mixup(gen, B, 0.2)[0] for _ in range(2000)])
    assert 0.0 <= lams.min() and lams.max() <= 1.0 and abs(lams.mean() - 0.5) < 0.05
    assert ((lams < 0.1) | (lams > 0.9)).mean() > 0.5
    assert sorted(spec_augment.draw_mixup(gen, B, 0.2)[1].tolist()) == list(range(B))


def test_mask_conv_equals_jax():
    x = lms(2)
    for ratio, seed in ((0.75, 0), (0.5, 1), (0.0, 2)):
        key = jax.random.key(seed)
        jx, jm = jmask_conv.mask_conv(key, jnp.asarray(x), ratio, (16, 16))
        noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (B, 8))))
        tx, tm = mask_conv(torch.from_numpy(x), ratio, (16, 16), noise=noise)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    tx, tm = mask_conv(torch.from_numpy(x), 0.75, gen=torch.Generator().manual_seed(0))
    assert tm.sum(dim=1).tolist() == [6.0] * B


_JAX_STATE = {}


def jax_state(jcfg):
    if "s" not in _JAX_STATE:
        _JAX_STATE["s"] = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    return _JAX_STATE["s"]


class RecordingJax:
    """Stands in for `jax` inside ssl_audio_tpu.eval.finetune: jit records
    the loss the jitted step returns."""

    def __init__(self):
        self.losses = []
        rec = self

        def jit(fn):
            jitted = jax.jit(fn)

            def call(*args):
                out = jitted(*args)
                if isinstance(out, tuple) and len(out) == 4:
                    rec.losses.append(float(out[3]))
                return out
            return call
        self.jit = jit

    def __getattr__(self, name):
        return getattr(jax, name)


def jax_classifier_draws(seed, n_steps, ft, alpha):
    """The port's ClassifierDraws of each step, from JAX train_classifier's
    key chain (the head's key first), and the head."""
    key = jax.random.key(seed)
    k_head, key = jax.random.split(key)
    out = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        k1, k = jax.random.split(k)
        k2, k3, k = jax.random.split(k, 3)
        out.append(finetune.ClassifierDraws(
            mixup=jax_mixup(k1, alpha), freq=jax_band(k2, 8), time=jax_band(k3, 20),
            dropout=torch.full((B, FRAMES // 4, 2048), 0.7) if ft else None))
    return k_head, out


# Adam's first steps are lr * m / (sqrt(v) + eps), about lr * sign(g) for
# every element: an element whose gradient is float noise on both sides (a
# conv bias before its BatchNorm: exactly 0 in exact arithmetic) moves by
# 2 lr the other way, and at lr 1e-3 the second step's running statistics
# then part by 1.6e-4.  The finetune case therefore runs at FINETUNE_LR,
# where two such steps stay within 1e-4, and holds each encoder
# parameter's change over the two steps against JAX's as well, as
# tests/test_torch_dino.py compare_changes does: relative L2 beyond one ulp
# of each element, the OUTLIERS share of a tensor's elements that differ
# most left out (where Adam's first moment nearly cancels in the second
# step, its ~lr step takes an arbitrary sign), to CHANGE_TOL (measured up
# to 2.5e-4); the two biases before a BatchNorm to the bound of two steps
# of lr.
FINETUNE_LR = 2e-5
SEED = 4        # JAX's key chain from it permutes the batch at both steps
CHANGE_TOL = 1e-3
OUTLIERS = 0.02
ZERO_GRAD = ("features.0.bias", "features.4.bias")


@pytest.mark.parametrize("mode", ["linear", "finetune"])
def test_train_classifier_matches_jax(monkeypatch, mode):
    # alpha 1: lambda ~ U(0, 1), so the order of mixup and the masks shows
    ft, alpha = mode == "finetune", 1.0
    lr = FINETUNE_LR if ft else 1e-3
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    recording = RecordingJax()
    monkeypatch.setattr(jfinetune, "jax", recording)
    jcfg, cfg = jax_config(**KW), default_config(**KW, device="cpu")
    mods, jstate = jax_state(jcfg)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    params, stats = jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray,
                                                                          jstate.batch_stats)
    encoder = state.modules["encoder"]
    encoder.load_state_dict(encoder_state_dict_from_jax(params["encoder"], stats["encoder"]))
    start = {k: v.detach().clone() for k, v in encoder.state_dict().items()}
    ds = SyntheticLMS(cfg, length=4 * B, n_classes=CLASSES)
    items = [ds[i] for i in range(4 * B)]
    batches = [(np.stack([x for x, _ in items[i:i + B]]), np.stack([y for _, y in items[i:i + B]]))
               for i in range(0, 4 * B, B)]
    train, val = batches[:2], batches[2:]

    jbest, jscore = jfinetune.train_classifier(
        mods, jstate.params, jstate.batch_stats, train, val, CLASSES, epochs=1, lr=lr,
        finetune=ft, mixup_alpha=alpha, specaug=True, seed=SEED)
    k_head, draws = jax_classifier_draws(SEED, 2, ft, alpha)
    assert all(d.mixup[1].tolist() != list(range(B)) for d in draws)   # mixup mixes
    D = encoder.embed_dim
    w = jax.random.uniform(k_head, (D, CLASSES), minval=-1 / np.sqrt(D), maxval=1 / np.sqrt(D))
    head = torch.nn.Linear(D, CLASSES)
    head.load_state_dict(classifier_head_from_jax({"w": np.asarray(w),
                                                   "b": np.zeros(CLASSES, np.float32)}))
    losses = []
    step = finetune.make_classifier_step

    def counted(*a, **kw):
        inner = step(*a, **kw)
        return lambda *b: losses.append(float(inner(*b))) or losses[-1]

    monkeypatch.setattr(finetune, "make_classifier_step", counted)
    best, score = finetune.train_classifier(
        cfg, encoder, train, val, CLASSES, epochs=1, lr=lr, finetune=ft, mixup_alpha=alpha,
        specaug=True, head=head, draws=lambda epoch, it, x: draws[it])

    np.testing.assert_allclose(losses, recording.losses, rtol=TOL)
    assert len(losses) == 2
    np.testing.assert_allclose(score, jscore, rtol=0, atol=TOL)
    want_head = classifier_head_from_jax(jax.tree.map(np.asarray, jbest["head"]))
    for k, v in best["head"].items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(), rtol=0, atol=TOL,
                                   err_msg=f"head.{k}")
    if not ft:
        assert set(best) == {"head"}
        for k, v in encoder.state_dict().items():       # frozen, eval mode throughout
            assert torch.equal(v, start[k]), k
        return
    want = encoder_state_dict_from_jax(jax.tree.map(np.asarray, jbest["encoder"]),
                                       jax.tree.map(np.asarray, jbest["encoder_batch_stats"]))
    for k, v in best["encoder_batch_stats"].items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, start[k]), f"{k} did not move"
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=k)
    for k, v in best["encoder"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=TOL, err_msg=k)
        got, exp = (v - start[k]).double(), (want[k] - start[k]).double()
        assert got.any(), f"{k} did not move"
        if k in ZERO_GRAD:
            assert float(got.abs().max()) <= 2 * lr * (1 + 1e-3), k
            continue
        err = (got - exp).abs().flatten()
        kept = err.argsort()[:err.numel() - int(OUTLIERS * err.numel())]
        ulps = np.linalg.norm(np.spacing(np.abs(want[k].numpy())).ravel()[kept.numpy()])
        gap = (float(err[kept].norm()) - ulps) / float(exp.flatten()[kept].norm())
        assert gap <= CHANGE_TOL, f"change of {k}: relative L2 {gap:.2e}"


def run_cli(monkeypatch, capsys, cwd, module, *args) -> str:
    """`python -m module *args` in the directory `cwd`, run in this process
    as -m runs it (runpy, the module as __main__, sys.argv its arguments):
    a new interpreter would spend seconds importing torch and compiling
    modules under the suite's load.  -> its standard output."""
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [module, *args])
    capsys.readouterr()
    with warnings.catch_warnings():     # the module is imported already: runpy says so
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    return capsys.readouterr().out


SMALL = ["--device", "cpu", "--dataset", "synthetic", "--batch_size", "4", "--crop_frames",
         "32", "--synthetic_steps_per_epoch", "2", "--num_workers", "1",
         "--projector_hidden_dim", "64"]


@pytest.mark.parametrize("argv", [
    ["ssl_audio_tpu_torch.evaluate", "--mode", "linear", "--eval_epochs", "2"],
    ["ssl_audio_tpu_torch.evaluate", "--mode", "finetune", "--eval_epochs", "1", "--specaug",
     "--eval_mixup", "0.2"],
    ["ssl_audio_tpu_torch.extract_embeddings", "--split", "test", "--out_prefix", "emb/syn"]])
def test_entry_points_on_the_cpu(tmp_path, monkeypatch, capsys, argv):
    out = run_cli(monkeypatch, capsys, tmp_path, argv[0], *SMALL, *argv[1:])
    if argv[0].endswith("evaluate"):
        assert f"{argv[2]} best val score: " in out
        assert f"[{argv[2]}] epoch 1/" in out
        return
    X, y = np.load(tmp_path / "emb/syn_X.npy"), np.load(tmp_path / "emb/syn_y.npy")
    assert X.shape == (8, 3072) and y.shape == (8, 10) and np.isfinite(X).all()
