"""The port's ResNet family (ssl_audio_tpu_torch/models/resnet.py) against
the JAX package's (ssl_audio_tpu/models/resnet.py) on the CPU, module by
module: every factory, the 7x7 stem and ResNet-D, odd T, the ReGP head's
ties, the init and the routing of build_encoder.  The training paths are
in tests/test_torch_resnet_train.py.

Module level: both packages from the same variables (the port's through
utils/weights.py resnet_state_dict_from_jax).  The witness is the JAX
module run in float64 (jax.enable_x64).  The port in float64 must equal it
to SAME_TOL: train- and eval-mode outputs, every gradient of a scalar of
the output, the running statistics.  The port in fp32 is held to TOL (1e-4,
BASELINE.md) in eval mode and for the running statistics, and to
TRAIN_FP32_TOL in train mode; its train-mode gradients are not compared:
a deep stack of batch statistics over two samples makes them ill-conditioned
in fp32 (JAX's own fp32 forward of a train-mode ResNet-50 is 2.8e-4 of its
largest value from its float64 one, the port's 1.7e-4; fp32 gradients of
either package move by tens of percent against float64 in the first
layers), so fp32 against fp32 would measure rounding, not the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models import resnet as jresnet
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.models import resnet
from ssl_audio_tpu_torch.train.state import build_encoder
from ssl_audio_tpu_torch.utils import weights
from ssl_audio_tpu_torch.utils.weights import resnet_state_dict_from_jax


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


TOL = 1e-4
SAME_TOL = 1e-9      # float64 against float64: the same function in other summation orders
TRAIN_FP32_TOL = 1e-3   # the port's fp32 train-mode output against the float64 witness


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, what, tol=TOL):
    """|a - b| within tol of b's largest magnitude (at least 1)."""
    b = np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a, np.float64), b, atol=tol * scale, rtol=0,
                               err_msg=what)


def to_f64(tree):
    """Every floating leaf of a JAX tree in float64 (under jax.enable_x64)."""
    return jax.tree.map(lambda x: x.astype(jnp.float64)
                        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _loss_weights(n: int, dim: int) -> np.ndarray:
    return np.random.default_rng(11).standard_normal((n, dim))


def jax_reference(factory: str, kw: dict, variables, x: np.ndarray, w: np.ndarray,
                  jit: bool = True):
    """The JAX module in float64: train-mode output, the gradient of
    sum(out * w) by parameter, the running statistics after that forward,
    and the eval-mode output with them; jitted, or op by op (see
    MODULE_CASES)."""
    model = getattr(jresnet, factory)(**kw)
    with jax.enable_x64(True):
        v64 = to_f64(variables)
        x64, w64 = jnp.asarray(x, jnp.float64), jnp.asarray(w, jnp.float64)

        def loss(params):
            out, upd = model.apply({"params": params, "batch_stats": v64["batch_stats"]}, x64,
                                   train=True, mutable=["batch_stats"])
            return (out * w64).sum(), (out, upd["batch_stats"])

        value_and_grad = jax.value_and_grad(loss, has_aux=True)
        (_, (out, stats)), grads = (jax.jit(value_and_grad) if jit else value_and_grad)(
            v64["params"])
        out_eval = jax.jit(lambda p, st: model.apply({"params": p, "batch_stats": st}, x64,
                                                      train=False))(v64["params"], stats)
        return (np.asarray(out), as_np(grads), as_np(stats), np.asarray(out_eval),
                model.embed_dim)


def seeded_variables(factory: str, kw: dict, shape, rng) -> dict:
    """The JAX module's variable tree (its shapes by jax.eval_shape, nothing
    initialised), filled from `rng`: conv kernels at the kaiming fan-out
    scale (the init's), BN scales, shifts and running statistics near their
    initial values.  (Negative scales leave channels dead after a ReLU: a
    batch-2 statistic over a constant channel has variance 0 and its
    gradient is rounding noise over sqrt(eps), in either framework.)"""
    model = getattr(jresnet, factory)(**kw)
    tree = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)}, jnp.zeros(shape),
                                             train=False))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        n = leaf.shape
        if "kernel" in name:
            std = np.sqrt(2.0 / (n[0] * n[1] * n[3]))
            return (std * rng.standard_normal(n)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        if "var" in name:
            return (0.5 + rng.random(n)).astype(np.float32)
        return (0.1 * rng.standard_normal(n)).astype(np.float32)        # shifts, means

    return jax.tree_util.tree_map_with_path(fill, tree)


def port_run(factory: str, kw: dict, sd: dict, x: np.ndarray, w: np.ndarray, dtype):
    model = getattr(resnet, factory)(**kw)
    model.load_state_dict(sd, strict=True)
    model.to(dtype).train()
    out = model(torch.from_numpy(x).to(dtype))
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items() if "running" in k}
    with torch.no_grad():
        out_eval = model.eval()(torch.from_numpy(x).to(dtype))
    return out.detach(), grads, stats, out_eval, model.embed_dim


MODULE_CASES = {
    # factory, keyword arguments, input (F, T), the JAX witness jitted: every
    # factory; the plain stride plans at the training crop (at 32 frames their
    # last stage is 2 x 1 and its batch-2 statistics over 4 values make any
    # fp32 forward ill-conditioned), the ReGP-NRF ones (last stage 8 x T/16)
    # at 32 frames too; odd T, where stride-2 convs round up and pools down,
    # on resnet18 here (tests/test_torch_hear_resnet.py serves all four ResNet
    # types, ReGP-NRF included, at T = 151 against JAX's wrapper).
    # resnet50_ReGP_NRF's witness runs op by op: the
    # jitted JAX gradient of that network on the CPU departs from JAX's own
    # finite differences (layer4.2.bn3.bias summed: jitted 165.49, un-jitted
    # 124.98, the port 124.98; the finite differences of JAX's forward agree
    # with the latter two), in float64 and in fp32, and so does
    # resnet18_ReGP_NRF's at 33 frames (at 32 it does not)
    "resnet18_odd_T": ("resnet18", {}, (64, 97), True),
    "resnet34": ("resnet34", {}, (64, 96), True),
    "resnet50": ("resnet50", {}, (64, 96), True),

    "resnet34_ReGP_NRF": ("resnet34_ReGP_NRF", {}, (64, 32), True),
    "resnet50_ReGP_NRF": ("resnet50_ReGP_NRF", {}, (64, 96), False),
    # the 7x7 stem and ResNet-D's average-pool projections (ResNet-D's VALID
    # pool needs even sizes, in JAX too)
    "resnet18_7x7_stem_D": ("resnet18", dict(C=False, D=True), (64, 96), True),
    # resnet18_ReGP_NRF with rows of zeros after the last ReLU: the last BN's
    # shift drives half the channels below zero at every frame
    "resnet18_ReGP_NRF_zero_rows": ("resnet18_ReGP_NRF", {}, (64, 32), True),
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_forward_gradients_and_statistics_match_jax(case, monkeypatch):
    factory, kw, (F, T), jit = MODULE_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, F, T)).astype(np.float32)
    variables = seeded_variables(factory, kw, (1, 1, F, T), rng)
    if case.endswith("zero_rows"):
        last = variables["params"]["layer4_1"]["bn2"]["bias"]
        last[::2] = -100.0
    sd = resnet_state_dict_from_jax(variables, factory, D=kw.get("D", False))
    w = _loss_weights(2, getattr(resnet, factory)(**kw).embed_dim)
    out_j, grads_j, stats_j, eval_j, dim_j = jax_reference(factory, kw, variables, x, w, jit)
    # the float64 witness's gradients and statistics under the port's names,
    # kept in float64 (the converter otherwise casts to the modules' fp32)
    monkeypatch.setattr(weights, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
    want = resnet_state_dict_from_jax({"params": grads_j, "batch_stats": stats_j}, factory,
                                      D=kw.get("D", False))
    if case.endswith("zero_rows"):                 # half the features: zero at every frame
        assert (out_j == 0.0).sum() >= out_j.size // 2
    out, grads, stats, out_eval, dim = port_run(factory, kw, sd, x, w, torch.float64)
    assert dim == dim_j == out.shape[1]
    close(out, out_j, "train-mode output", SAME_TOL)
    close(out_eval, eval_j, "eval-mode output", SAME_TOL)
    for k, g in grads.items():
        close(g, want[k], f"gradient of {k}", SAME_TOL)
    for k, v in stats.items():
        close(v, want[k], k, SAME_TOL)
    out, _, stats, out_eval, _ = port_run(factory, kw, sd, x, w, torch.float32)
    close(out, out_j, "fp32 train-mode output", TRAIN_FP32_TOL)
    close(out_eval, eval_j, "fp32 eval-mode output", TOL)
    for k, v in stats.items():
        close(v, want[k], f"fp32 {k}", TOL)


def test_regp_head_shares_tied_maxima_as_jax():
    """The ReGP head on a tensor with rows of zeros and tied positive maxima
    over time: its output and its gradient equal JAX's expression
    (models/resnet.py:156-160), which jnp.max differentiates by sharing a
    tie evenly (max(dim) would hand it to one frame)."""
    rng = np.random.default_rng(5)
    h = np.maximum(rng.standard_normal((2, 8, 4, 6)), 0.0).astype(np.float32)   # (B, C, F, T)
    h[:, :3] = 0.0                           # whole rows of zeros: every frame ties
    h[:, 3, :, 1:4] = 2.5                    # positive ties
    g = rng.standard_normal((2, 32)).astype(np.float32)

    def jax_head(hh):                        # JAX's NHWC tensor is (B, F, T, C)
        B, Fr, T, C = hh.shape
        hh = jnp.transpose(hh, (0, 2, 1, 3)).reshape(B, T, Fr * C)
        return (hh.max(axis=1) + hh.mean(axis=1)) * g

    h_nhwc = np.transpose(h, (0, 2, 3, 1))
    out_j, vjp = jax.vjp(lambda a: jax_head(a), jnp.asarray(h_nhwc))
    (grad_j,) = vjp(jnp.ones_like(out_j))
    ht = torch.from_numpy(h).requires_grad_()
    out = resnet.regp_pooling(ht) * torch.from_numpy(g)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.transpose(ht.grad.numpy(), (0, 2, 3, 1)), np.asarray(grad_j),
                               rtol=1e-6, atol=1e-6)
    assert float(ht.grad[:, 3, :, 1:4].abs().min()) > 0        # shared, not handed to one


def test_embed_dims_and_init():
    """embed_dim per factory as JAX's; the init draws JAX's kaiming fan-out
    normal (untruncated) with BN at 1 / 0, so a conv's weights have std
    sqrt(2 / (kh kw out)) and reach past 2 std."""
    for name in resnet.FACTORIES:
        assert getattr(resnet, name)().embed_dim == getattr(jresnet, name)().embed_dim
    m = resnet.init_resnet_weights_(resnet.resnet50(), torch.Generator().manual_seed(0))
    w = m.layer1[0].conv2.weight.detach()                     # (64, 64, 3, 3)
    std = (2.0 / (64 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02 and float(w.abs().max()) > 3 * std
    assert torch.equal(m.layer1[0].bn1.weight, torch.ones(64))
    assert torch.equal(m.layer1[0].bn1.bias, torch.zeros(64))


def test_build_encoder_routes_the_resnets():
    """The four ResNet model types as JAX routes them (defaults: deep stem,
    plain projections), --squeeze_excitation and --remat ignored, as there."""
    for mt, dim in (("resnet18", 512), ("resnet18_ReGP_NRF", 4096), ("resnet50", 2048),
                    ("resnet50_ReGP_NRF", 16384)):
        enc, d = build_encoder(default_config(model_type=mt, squeeze_excitation=True,
                                              remat=True))
        assert isinstance(enc, resnet.ResNet) and d == dim == enc.embed_dim
        assert enc.C and "layer1.0.conv1.weight" in enc.state_dict()
