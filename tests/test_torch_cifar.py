"""CIFAR-10 pretraining in the port (data/cifar10.py, augment/cifar.py, the
CIFAR ViT of train/state.py build_encoder, the cifar10 routing of the step,
eval/cifar_knn.py and main's kNN hook) against the JAX package on the CPU,
on a CIFAR-10 tree written here in the published pickle layout
(tests/test_cifar.py write_fake_cifar).

Sizes: both packages' ViT "tiny" patched to width 64, depth 2, 4 heads for
the step (8 x 8 patches: 16 tokens + CLS), batch 4, projector hidden 64.
Randomness: JAX's CIFAR draws replayed from its key splits
(jax_cifar_draws); the token-mask noise handed to both (JaxDraws); the step
is given JAX's views (its own are held to VIEWS_ATOL first).

Tolerances: the views 1e-5 absolute (fp32 resample products and colour
algebra in another order: measured ~2e-6); the ViT forward 1e-5 of
max|ref|; the step's loss and every gradient 1e-4 (fp32, BASELINE.md;
a gradient per tensor in relative L2);
the kNN monitor's top-1 / top-5 exactly (the same weights, fp32
embeddings far from any vote tie)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.augment import cifar as jcifar
from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.data.cifar10 import Cifar10 as JCifar10
from ssl_audio_tpu.eval.cifar_knn import make_cifar_knn_eval_fn as jax_knn_fn
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train import loop as jloop
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu_torch.augment import cifar
from ssl_audio_tpu_torch.config import default_config, require_supported
from ssl_audio_tpu_torch.data.cifar10 import Cifar10
from ssl_audio_tpu_torch.eval.cifar_knn import make_cifar_knn_eval_fn
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train import loop
from ssl_audio_tpu_torch.train import steps as tsteps
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_cifar10
from ssl_audio_tpu_torch.train.steps import StepDraws, make_train_step
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests.test_cifar import write_fake_cifar
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_finetune import run_cli
from tests.test_torch_vit import JaxDraws
from tests.test_torch_vit_train_step import adam_first_moments

B = 4
VIEWS_ATOL = 1e-5
FWD_RTOL = 1e-5
TOL = 1e-4
KW = dict(dataset="cifar10", model_type="vit_tiny", batch_size=B, patch_size=[8, 8],
          projector_hidden_dim=64, wd=0.0, mask=True, mask_ratio=0.5, token_drop=False,
          num_workers=1, seed=0)
TOKENS = 16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    write_fake_cifar(str(root / "data"), n_train=40, n_test=16)
    # the layout chip_smoke.py writes, beside the JAX tests' own
    fabricate_cifar10(str(root / "fabricated"), rows=12, seed=1)
    return root


@pytest.fixture
def small_vits(monkeypatch):
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    monkeypatch.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
    monkeypatch.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})


_JAX_STATES = {}


def jax_state(jcfg):
    """(mods, jstate) of the JAX init_train_state for jcfg and key 0, made
    once per module (the ViT's eager flax init compiles op by op)."""
    key = repr(jcfg)
    if key not in _JAX_STATES:
        _JAX_STATES[key] = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    return _JAX_STATES[key]


def port_state(cfg, jstate):
    """The port's train state for cfg with the JAX state's weights."""
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    sds = train_state_dicts_from_jax(jax.tree.map(np.asarray, jstate.params),
                                     jax.tree.map(np.asarray, jstate.batch_stats),
                                     vit_spec=state.modules["encoder"].spec)
    for name, module in state.modules.items():
        module.load_state_dict(sds[name], strict=True)
    return state


def jax_cifar_draws(key, batch: int) -> cifar.CifarPairDraws:
    """What jcifar.cifar_pair_views(key, ...) draws, in CIFAR_DRAWS order."""
    def one(k):
        ks = jax.random.split(k, 5)
        kc = jax.random.split(ks[0], 4)
        kb, kk, ksat, kh = jax.random.split(ks[3], 4)
        u = jax.random.uniform
        return jnp.stack([
            u(kc[0], (), minval=0.08, maxval=1.0),
            u(kc[1], (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3)),
            u(kc[2], ()), u(kc[3], ()), u(ks[1], ()), u(ks[2], ()),
            u(kb, (), minval=0.6, maxval=1.4), u(kk, (), minval=0.6, maxval=1.4),
            u(ksat, (), minval=0.6, maxval=1.4), u(kh, (), minval=-0.1, maxval=0.1),
            u(ks[4], ())])
    views = [np.asarray(jax.vmap(one)(jax.random.split(k, batch)))
             for k in jax.random.split(key)]
    return cifar.CifarPairDraws(torch.from_numpy(np.stack(views, axis=1)))


@pytest.mark.parametrize("train,where", [(True, "data"), (False, "data"),
                                         (True, "fabricated")])
def test_cifar10_arrays_equal_jax(tree, train, where):
    ours, theirs = Cifar10(str(tree / where), train), JCifar10(str(tree / where), train)
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.images.dtype == np.uint8 and ours.images.shape[1:] == (32, 32, 3)
    assert len(ours) == len(theirs) and ours.label_num == theirs.label_num == 10
    for i in (0, len(ours) - 1):
        (x, y), (jx, jy) = ours[i], theirs[i]
        np.testing.assert_array_equal(x, jx)
        assert y == jy and type(y) is type(jy)
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        Cifar10(str(tree / "nothing"))


def test_pair_views_and_eval_batch_match_jax():
    imgs = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    key = jax.random.key(3)
    ours = cifar.apply_cifar_pair_views(torch.from_numpy(imgs), jax_cifar_draws(key, 8))
    theirs = jcifar.cifar_pair_views(key, jnp.asarray(imgs))
    for o, t in zip(ours, theirs):
        assert o.shape == (8, 3, 32, 32) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=0, atol=VIEWS_ATOL)
    np.testing.assert_allclose(cifar.cifar_eval_batch(torch.from_numpy(imgs)).numpy(),
                               np.asarray(jcifar.cifar_eval_batch(jnp.asarray(imgs))),
                               rtol=0, atol=VIEWS_ATOL)
    # the draws from a generator lie in each value's range
    d = cifar.draw_cifar_pair_views(torch.Generator().manual_seed(0), 256).values
    lo, hi = d.amin(dim=(0, 1)), d.amax(dim=(0, 1))
    col = {n: i for i, n in enumerate(cifar.CIFAR_DRAWS)}
    assert 0.08 <= lo[col["area"]] and hi[col["area"]] <= 1.0
    assert -0.1 <= lo[col["hue"]] and hi[col["hue"]] <= 0.1
    assert 0.6 <= lo[col["contrast"]] and hi[col["brightness"]] <= 1.4


def test_cifar_vit_forward_matches_jax(small_vits):
    jcfg, cfg = jax_config(**KW), default_config(**KW, device="cpu")
    mods, jstate = jax_state(jcfg)
    state = port_state(cfg, jstate)
    enc = state.modules["encoder"].eval()
    assert enc.spec.img_size == (32, 32) and enc.spec.in_chans == 3
    assert not hasattr(enc, "decoder_embed")
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref, _ = mods.apply_encoder(jstate.params["encoder"], jstate.batch_stats["encoder"],
                                jnp.asarray(x), train=False)
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=FWD_RTOL * np.abs(ref).max())


def test_barlow_twins_step_on_cifar10_matches_jax(small_vits, monkeypatch):
    """One step from the same weights on JAX's views: the loss and every
    gradient (AdamW's first moment after one step is 0.1 g in both) within
    1e-4; the port's own views within VIEWS_ATOL of JAX's."""
    jcfg, cfg = jax_config(**KW), default_config(**KW, device="cpu")
    mods, jstate = jax_state(jcfg)
    state = port_state(cfg, jstate)
    raw = jax_make_train_step(mods, raw=True)

    def step_and_views(jstate, batch, key):
        seen = []
        make_views = mods.make_views
        mods.make_views = lambda *a: seen.append(make_views(*a)) or seen[0]
        try:
            jstate, metrics = raw(jstate, batch, key, np.float32(0.5))
        finally:
            mods.make_views = make_views
        return jstate, metrics, seen[0][0]

    noise = np.random.default_rng(2).random((B, TOKENS)).astype(np.float32)
    monkeypatch.setattr(jvit, "jax", JaxDraws(noise=[noise]))
    imgs = np.random.default_rng(3).integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    key = jax.random.key(5)
    jstate, jmetrics, jviews = jax.jit(step_and_views)(jstate, jnp.asarray(imgs), key)
    jviews = [torch.from_numpy(np.array(v)) for v in jviews]
    apply = tsteps.apply_cifar_pair_views
    gaps = []

    def replay(batch, draws):
        gaps.append(max(float((a - b).abs().max()) for a, b in zip(apply(batch, draws), jviews)))
        return jviews

    monkeypatch.setattr(tsteps, "apply_cifar_pair_views", replay)
    # the views' key is _split_rngs(key)["aug"], the first of five
    draws = StepDraws(None, jax_cifar_draws(jax.random.split(key, 5)[0], B),
                      noise=[torch.from_numpy(noise), torch.rand(B, TOKENS)])
    metrics = make_train_step(cfg)(state, torch.from_numpy(imgs), draws=draws, mask_ratio=0.5)
    assert gaps and max(gaps) <= VIEWS_ATOL
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=TOL)
    mu = adam_first_moments(jstate.opt_state, jstate.params)
    want = train_state_dicts_from_jax(mu, jax.tree.map(np.asarray, jstate.batch_stats),
                                      vit_spec=state.modules["encoder"].spec)
    n = 0
    for name, module in state.modules.items():
        for k, p in module.named_parameters():
            if not p.requires_grad:             # the frozen patch projection
                continue
            g, jg = p.grad.double(), want[name][k].double() / 0.1
            if f"{name}.{k}" == "encoder.norm.bias":
                # the projector's BatchNorm removes a shift of every latent: its
                # gradient is 0 + float noise on both sides (measured 2.4e-5)
                assert float((g - jg).abs().max()) <= TOL
                continue
            rel = float((g - jg).norm() / jg.norm())       # measured <= 4.4e-5
            assert rel <= TOL, f"gradient of {name}.{k}: relative L2 {rel:.2e}"
            n += 1
    assert n > 20


def test_knn_monitor_matches_jax(small_vits, tree, monkeypatch):
    monkeypatch.chdir(tree)
    jcfg, cfg = jax_config(**KW), default_config(**KW, device="cpu")
    mods, jstate = jax_state(jcfg)
    state = port_state(cfg, jstate)
    ours = make_cifar_knn_eval_fn(cfg)(state, 1)
    theirs = jax_knn_fn(jcfg)(mods, jstate, 1)
    assert ours == theirs
    with pytest.raises(FileNotFoundError):
        make_cifar_knn_eval_fn(cfg, data_dir="nothing")


def test_routing_and_refusals(small_vits, tree):
    """get_train_dataset reads Cifar10 under data_dir as JAX's does; an
    encoder other than the ViT family raises ValueError before any work;
    --distributed with cifar10 runs (tests/test_torch_dist_train.py), with
    FSDP it is refused."""
    cfg, jcfg = default_config(**KW, device="cpu"), jax_config(**KW)
    ds, jds = loop.get_train_dataset(cfg, str(tree / "data")), \
        jloop.get_train_dataset(jcfg, str(tree / "data"))
    assert type(ds).__name__ == type(jds).__name__ == "Cifar10"
    np.testing.assert_array_equal(ds.images, jds.images)
    for model_type in ("audiontt", "resnet18"):
        with pytest.raises(ValueError, match="ViT family"):
            require_supported(cfg.replace(model_type=model_type))
    require_supported(cfg.replace(distributed=True))
    with pytest.raises(NotImplementedError, match="--fsdp"):
        require_supported(cfg.replace(distributed=True, fsdp=True))
    assert tsteps.pass_sizes(cfg) == [(32, 32)] * 2
    assert tsteps.pass_sizes(cfg.replace(local_crops_number=2), byol=True) == [(32, 32)] * 4


@pytest.mark.parametrize("module", ["ssl_audio_tpu_torch.main",
                                    "ssl_audio_tpu_torch.main_bt_byol"])
def test_entry_points_train_on_cifar10(tree, monkeypatch, capsys, module):
    """main (with the kNN monitor after the epoch) and main_bt_byol train a
    ViT on the CIFAR-10 tree, with the fused attention's plain versions, as
    `python -m` runs them."""
    out = run_cli(monkeypatch, capsys, tree, module, "--device", "cpu", "--dataset", "cifar10",
                  "--model_type", "vit_tiny", "--batch_size", "8", "--epochs", "1",
                  "--projector_hidden_dim", "64", "--num_workers", "1", "--fused_attention",
                  "--mask", "--mask_ratio", "0.5", "--save_base_dir", module)
    assert "Epoch [1/1] loss=" in out and "on cpu" in out
    assert "[epoch 1] cifar10 kNN top1=" in out
    assert list((tree / module).glob("results/cifar10/*/model_1.pt"))
