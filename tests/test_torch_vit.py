"""The port's ViT (ssl_audio_tpu_torch/models/vit.py) against the JAX
package's MaskedAutoencoderViT on the CPU, from the same weights (converted
by utils/weights.py vit_state_dict_from_jax) and the same random draws.

Randomness: the JAX module draws its token-mask noise with
jax.random.uniform and DropPath's masks with jax.random.bernoulli; the tests
replace the `jax` that ssl_audio_tpu.models.vit sees with one whose two
draws hand out numpy arrays the test made, and give the port the same
arrays.  Sizes: depth 2, width 64 (4 heads of 16), the (64, 96) log-mel
grid of 24 patches, batch 4; the conv-stem variant (ViT-C) runs its four
stride-2 convolutions with flax BatchNorm semantics.

Tolerance: fp32, 1e-4 of each tensor's largest value (BASELINE.md), which
also covers flax's one-pass LayerNorm variance against PyTorch's two-pass
one (measured here: up to ~1e-6).  The fused-attention case holds both
packages' bf16-operand kernels against each other: an element at a bf16
rounding boundary may round the other way on one side, so it allows one
bf16 spacing of the largest value and 1e-3 in relative L2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.utils.torch_export import export_vit_state_dict
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.utils.weights import vit_state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L = 4, 24
TOL = 1e-4
SPEC = dict(img_size=(64, 96), patch_size=(16, 16), embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)


class JaxDraws:
    """Stands in for `jax` inside ssl_audio_tpu.models.vit: random.uniform
    and random.bernoulli return the given arrays, in order."""

    def __init__(self, noise=(), keep=()):
        self.noise, self.keep = list(noise), list(keep)
        draws = self

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def uniform(self, key, shape, *args, **kwargs):
                n = draws.noise.pop(0)
                assert n.shape == tuple(shape)
                return jnp.asarray(n)

            def bernoulli(self, key, p, shape):
                k = draws.keep.pop(0)
                return jnp.asarray(k).reshape(shape)

        self.random = Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def make_pair(**kw):
    """(JAX module, its variables, the port's module with the same weights)."""
    spec = {**SPEC, **kw}
    jmodel = jvit.MaskedAutoencoderViT(jvit.ViTSpec(**spec))
    key = jax.random.key(0)
    x = jnp.zeros((2, 1) + tuple(spec["img_size"]))
    variables = jmodel.init({"params": key, "mask": key, "droppath": key}, x,
                            mask_ratio=0.5, masked_recon=spec.get("use_decoder", False))
    variables = jax.tree.map(np.asarray, dict(variables))
    # some weights away from their initial zeros and ones, so every path counts
    rng = np.random.default_rng(1)
    variables["params"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    model = vit.MaskedAutoencoderViT(vit.ViTSpec(**spec))
    model.load_state_dict(vit_state_dict_from_jax(
        variables["params"], variables.get("batch_stats"), model.spec), strict=True)
    return jmodel, variables, model


def images(seed=0, shape=(B, 1, 64, 96)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(a, b, what, tol=TOL):
    a, b = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol, err_msg=what)


def jax_apply(monkeypatch, jmodel, variables, x, train, draws=None, **kw):
    monkeypatch.setattr(jvit, "jax", draws or JaxDraws())
    out, mut = jmodel.apply(variables, jnp.asarray(x), train=train,
                            rngs={"mask": jax.random.key(5), "droppath": jax.random.key(6)},
                            mutable=["batch_stats"], **kw)
    return out, mut


MASKINGS = {"none": dict(mask_ratio=0), "key_bias": dict(mask_ratio=0.75),
            "token_drop": dict(mask_ratio=0.75, len_keep=6)}


@pytest.mark.parametrize("conv_stem", [False, True])
@pytest.mark.parametrize("masking", list(MASKINGS))
def test_train_forward_matches_jax(monkeypatch, conv_stem, masking):
    """CLS latent, mean-pooled latent and all tokens in train mode, for both
    maskings from the same noise; the ConvStem's running statistics."""
    jmodel, variables, model = make_pair(conv_stem=conv_stem)
    x = images()
    noise = np.random.default_rng(2).random((B, L)).astype(np.float32)
    model.train()
    for i, kw in enumerate((dict(), dict(mean_pool=True), dict(return_all=True))):
        kw = {**MASKINGS[masking], **kw}
        want, mut = jax_apply(monkeypatch, jmodel, variables, x, True,
                              JaxDraws(noise=[noise]), **kw)
        got = model(torch.from_numpy(x), noise=torch.from_numpy(noise), **kw)
        close(got, want, f"{masking} {kw}")
        if conv_stem and i == 0:           # one update of the running statistics
            sd = model.state_dict()
            want_sd = vit_state_dict_from_jax(variables["params"], mut["batch_stats"],
                                              model.spec)
            for k in sd:
                if k.endswith(("running_mean", "running_var")):
                    close(sd[k], want_sd[k], k)


@pytest.mark.parametrize("conv_stem", [False, True])
def test_eval_forward_matches_jax(monkeypatch, conv_stem):
    """Eval mode: the ConvStem's BatchNorm takes its running statistics and
    DropPath is off."""
    jmodel, variables, model = make_pair(conv_stem=conv_stem, drop_path_rate=0.3)
    x = images(3)
    want, _ = jax_apply(monkeypatch, jmodel, variables, x, False, mean_pool=True)
    model.eval()
    close(model(torch.from_numpy(x), mean_pool=True), want, "eval")


def test_both_maskings_keep_the_same_tokens():
    """Key-bias masking and token drop from one noise: the same CLS latent,
    mean-pooled latent and mask (the JAX module's own equivalence)."""
    _, _, model = make_pair(conv_stem=True)
    model.train()
    x = torch.from_numpy(images(4))
    noise = torch.from_numpy(np.random.default_rng(5).random((B, L)).astype(np.float32))
    for mean_pool in (False, True):
        a = model(x, mask_ratio=0.75, noise=noise, mean_pool=mean_pool)
        b = model(x, mask_ratio=0.75, len_keep=vit.len_keep_for(L, 0.75), noise=noise,
                  mean_pool=mean_pool)
        close(a, b.detach(), f"mean_pool={mean_pool}", tol=1e-5)
    _, mask, _, _ = model.prepare_tokens(x, 0.75, noise=noise)
    _, mask_drop, _, ids = model.prepare_tokens(x, 0.75, len_keep=6, noise=noise)
    assert torch.equal(mask, mask_drop) and ids.shape == (B, 6)
    assert torch.equal(mask.sum(1), torch.full((B,), 18.0))


@pytest.mark.parametrize("token_drop", [False, True])
@pytest.mark.parametrize("norm_pix_loss", [False, True])
def test_masked_recon_matches_jax(monkeypatch, token_drop, norm_pix_loss):
    """The MAE decoder and its masked-patch loss behind the teacher view."""
    jmodel, variables, model = make_pair(use_decoder=True, norm_pix_loss=norm_pix_loss)
    x = images(6)
    noise = np.random.default_rng(7).random((B, L)).astype(np.float32)
    kw = dict(mask_ratio=0.75, masked_recon=True, **(dict(len_keep=6) if token_drop else {}))
    (want, want_loss), _ = jax_apply(monkeypatch, jmodel, variables, x, True,
                                     JaxDraws(noise=[noise]), **kw)
    model.train()
    got, loss = model(torch.from_numpy(x), noise=torch.from_numpy(noise), **kw)
    close(got, want, "latent")
    close(loss, want_loss, "recon loss")


def test_gradients_match_jax_grad(monkeypatch):
    """Gradients of every parameter through key-bias masking, DropPath with
    injected keep masks, the ConvStem and the decoder."""
    jmodel, variables, model = make_pair(conv_stem=True, use_decoder=True,
                                         drop_path_rate=0.5)
    rng = np.random.default_rng(8)
    x = images(9)
    noise = rng.random((B, L)).astype(np.float32)
    keep = (rng.random((2, B)) < 0.5).astype(np.float32)     # block 1's two branches
    w = rng.standard_normal((B, 64)).astype(np.float32)

    def jloss(params):
        (latent, recon), _ = jax_apply(
            monkeypatch, jmodel, {**variables, "params": params}, x, True,
            JaxDraws(noise=[noise], keep=[keep[0], keep[1]]),
            mask_ratio=0.5, masked_recon=True)
        return jnp.sum(latent * w) + recon

    jgrads = jax.jit(jax.grad(jloss))(variables["params"])
    model.train()
    latent, recon = model(torch.from_numpy(x), mask_ratio=0.5, masked_recon=True,
                          noise=torch.from_numpy(noise),
                          drop_keep=[None, torch.from_numpy(keep).bool()])
    ((latent * torch.from_numpy(w)).sum() + recon).backward()
    want = vit_state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                   variables["batch_stats"], model.spec)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for k, p in named.items():
        g = want[k].double()
        assert float(g.norm()) > 0, k
        err = float((p.grad.double() - g).norm() / g.norm())
        assert err <= TOL, f"{k}: relative L2 {err:.2e}"


@pytest.mark.parametrize("out_hw", [(5, 9), (2, 3), (4, 8), (3, 6)])
def test_bicubic_resize_matches_jax_image_resize(out_hw):
    """Up- and down-sampled grids (antialiased when shrinking), one axis at a time too."""
    table = np.random.default_rng(10).standard_normal((4, 6, 16)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(table), out_hw + (16,), "bicubic")
    got = vit._resize_bicubic_static(torch.from_numpy(table), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_position_table_resized_for_another_input_size(monkeypatch):
    """An input of (64, 128) frames: the (4, 6) table resized to (4, 8)."""
    jmodel, variables, model = make_pair(use_learned_pos_embd=True)
    x = images(11, (2, 1, 64, 128))
    want, _ = jax_apply(monkeypatch, jmodel, variables, x, False, return_all=True)
    model.eval()
    close(model(torch.from_numpy(x), return_all=True), want, "tokens")


def test_fused_attention_model_matches_jax_fused_model(monkeypatch):
    """Depth 1 with fused attention on both sides (the JAX kernel in
    interpret mode): latent and gradients at the bf16 level."""
    jmodel, variables, model = make_pair(depth=1, fused_attention=True)
    rng = np.random.default_rng(12)
    x = images(13)
    noise = rng.random((B, L)).astype(np.float32)
    w = rng.standard_normal((B, 64)).astype(np.float32)

    def jloss(params):
        latent, _ = jax_apply(monkeypatch, jmodel, {**variables, "params": params}, x, True,
                              JaxDraws(noise=[noise]), mask_ratio=0.5)
        return jnp.sum(latent * w), latent

    (_, jlatent), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    model.train()
    latent = model(torch.from_numpy(x), mask_ratio=0.5, noise=torch.from_numpy(noise))
    (latent * torch.from_numpy(w)).sum().backward()
    want = vit_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), {}, model.spec)
    pairs = [("latent", latent.detach(), torch.from_numpy(np.array(jlatent)))]
    pairs += [(k, p.grad, want[k]) for k, p in model.named_parameters()]
    for k, got, ref in pairs:
        diff = (got.double() - ref.double())
        assert float(diff.abs().max()) <= 2.0 ** -7 * float(ref.abs().max()), k
        assert float(diff.norm()) <= 1e-3 * float(ref.double().norm()), k
    # and the fused model is another function than the fp32 einsum one
    einsum = vit.MaskedAutoencoderViT(vit.ViTSpec(**{**SPEC, "depth": 1}))
    einsum.load_state_dict(model.state_dict())
    other = einsum.train()(torch.from_numpy(x), mask_ratio=0.5, noise=torch.from_numpy(noise))
    assert 1e-5 < float((other - latent).detach().abs().max()) < 1e-1


def test_return_attention_takes_the_einsum_path():
    """A block asked for its attention maps takes the fp32 einsum path even
    when the model is fused: the JAX Block's maps, with a masked key bias."""
    jmodel, variables, model = make_pair(fused_attention=True)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((B, L + 1, 64)).astype(np.float32)
    mask = (rng.random((B, L)) < 0.5).astype(np.float32)
    key_bias = np.pad((mask * jvit.NEG_INF)[:, None, None, :], ((0, 0),) * 3 + ((1, 0),))
    jblock = jvit.Block(64, 4, fused_attention=True)
    want = jblock.apply({"params": variables["params"]["block0"]}, jnp.asarray(x),
                        jnp.asarray(key_bias), False, True)
    got = model.blocks[0](torch.from_numpy(x), torch.from_numpy(key_bias),
                          return_attention=True)
    assert got.shape == (B, 4, L + 1, L + 1)
    close(got, want, "attention maps")
    torch.testing.assert_close(got.sum(-1), torch.ones(B, 4, L + 1))


@pytest.mark.parametrize("kw", [dict(conv_stem=True, use_decoder=True),
                                dict(use_learned_pos_embd=True)])
def test_state_dict_names_are_the_exporters(kw):
    """The port's parameter and buffer names are export_vit_state_dict's."""
    jmodel, variables, model = make_pair(**kw)
    exported = export_vit_state_dict(jmodel, variables["params"], variables.get("batch_stats"))
    assert set(model.state_dict()) == set(exported)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(exported[k].shape), k
    if kw.get("use_decoder"):
        # the exporter writes a 2-D decoder table; the JAX model adds the 1-D
        # one, and the port follows the model
        jtable = jvit.get_sinusoid_encoding_table(24, 32, cls_token=True)[None]
        assert np.array_equal(model.decoder_pos_embed.numpy(), jtable)
        assert not np.allclose(exported["decoder_pos_embed"].numpy(), jtable)


def test_sizes_and_conv_stem_plans():
    for size, (dim, depth, heads) in (("tiny", (192, 12, 3)), ("small", (384, 12, 6)),
                                      ("base", (768, 12, 12))):
        for c in (False, True):
            m = vit.get_mae_vit(size, c=c)
            assert (m.embed_dim, len(m.blocks), m.blocks[0].attn.num_heads) == \
                (dim, depth - int(c), heads)
    m = vit.get_mae_vit("tiny", [16, 8], c=True)
    assert m.patch_embed(torch.zeros(2, 1, 64, 96)).shape == (2, 4 * 12, 192)
    assert vit.ConvStem.strides_for((16, 8)) == jvit.ConvStem.strides_for((16, 8))
    with pytest.raises(ValueError):
        vit.ConvStem.strides_for((4, 4))
