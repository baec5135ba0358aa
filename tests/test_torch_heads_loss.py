"""The port's projector / predictor heads and Barlow Twins loss against the
JAX package's on the CPU: values, gradients, and the running statistics
after one training-mode call (flax folds the *biased* batch variance into
the running variance; torch's own BatchNorm would fold the unbiased one).
Inputs and weights come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models.heads import BarlowTwinsHead as JHead
from ssl_audio_tpu.models.heads import BarlowTwinsPredictor as JPredictor
from ssl_audio_tpu.objectives.barlow import barlow_twins_loss as jax_loss
from ssl_audio_tpu_torch.models.heads import BarlowTwinsHead, BarlowTwinsPredictor
from ssl_audio_tpu_torch.objectives.barlow import barlow_twins_loss
from ssl_audio_tpu_torch.utils.weights import _mlp_state_dict_from_jax
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4   # fp32 (BASELINE.md)


def randomised(variables, seed):
    """flax init variables with every leaf redrawn (BN scale, bias and
    running statistics included), as numpy."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(leaf.shape[0])
        if name in ("scale", "var"):
            return (1.0 + 0.2 * np.abs(a)).astype(np.float32)
        return 0.3 * a

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("kind,n_hidden", [("head", 1), ("head", 2), ("predictor", 1)])
def test_head_values_grads_and_running_stats_match_jax(kind, n_hidden):
    B, D_in, H, D_out = 8, 48, 64, 24
    rng = np.random.default_rng(0)
    if kind == "head":
        jmod = JHead(n_hidden, H, D_out)
        ours = BarlowTwinsHead(D_in, n_hidden, H, D_out)
        seq, prefix = ours.projector, "projector"
    else:
        D_in = D_out
        jmod = JPredictor(use=True)
        ours = BarlowTwinsPredictor(D_in, use=True)
        seq, prefix = ours.predictor, "predictor"
    x = rng.standard_normal((B, D_in)).astype(np.float32)
    dz = rng.standard_normal((B, D_out)).astype(np.float32)
    variables = randomised(jmod.init(jax.random.key(0), jnp.asarray(x), train=False), 1)
    sd = _mlp_state_dict_from_jax(variables["params"], variables["batch_stats"], prefix)
    ours.load_state_dict(sd, strict=True)

    def loss(params):
        out, mut = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * dz), (out, mut["batch_stats"])

    (_, (ref, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    ours.train()
    out = ours(torch.from_numpy(x))
    (out * torch.from_numpy(dz)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=TOL)
    got = {k: v.grad for k, v in ours.named_parameters()}
    want = _mlp_state_dict_from_jax(jax.tree.map(np.asarray, grads),
                                    jax.tree.map(np.zeros_like, new_stats), prefix)
    for k, g in got.items():
        scale = max(1.0, float(want[k].abs().max()))
        torch.testing.assert_close(g, want[k], atol=TOL * scale, rtol=TOL, msg=k)
    after = _mlp_state_dict_from_jax(variables["params"],
                                     jax.tree.map(np.asarray, new_stats), prefix)
    for k, v in ours.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, after[k], atol=1e-5, rtol=1e-5, msg=k)
    # the running variance took the biased batch variance: torch's own
    # BatchNorm1d would have folded var * B / (B - 1)
    bn = seq[1]
    h = seq[0](torch.from_numpy(x)).detach()
    biased = 0.9 * sd[f"{prefix}.1.running_var"] + 0.1 * h.var(0, unbiased=False)
    unbiased = 0.9 * sd[f"{prefix}.1.running_var"] + 0.1 * h.var(0, unbiased=True)
    torch.testing.assert_close(bn.running_var, biased, atol=1e-5, rtol=1e-5)
    assert float((bn.running_var - unbiased).abs().max()) > 1e-3
    assert int(bn.num_batches_tracked) == 1


def test_predictor_off_is_identity():
    x = torch.randn(3, 5)
    assert torch.equal(BarlowTwinsPredictor(5, use=False)(x), x)
    assert len(BarlowTwinsPredictor(5, use=False).state_dict()) == 0


@pytest.mark.parametrize("hsic", [False, True])
@pytest.mark.parametrize("world_scale", [1.0, 4.0])
@pytest.mark.parametrize("n_student,n_teacher", [(1, 1), (3, 1), (2, 2)])
def test_barlow_twins_loss_and_grads_match_jax(hsic, world_scale, n_student, n_teacher):
    rng = np.random.default_rng(2)
    zs = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(n_student)]
    zt = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(n_teacher)]
    kw = dict(lmbda=0.005, alpha=1.0, HSIC=hsic, world_scale=world_scale)
    ref, (gs, gt) = jax.value_and_grad(
        lambda s, t_: jax_loss(s, t_, **kw), argnums=(0, 1))(zs, zt)
    ts = [torch.tensor(z, requires_grad=True) for z in zs]
    tt = [torch.tensor(z, requires_grad=True) for z in zt]
    loss = barlow_twins_loss(ts, tt, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=TOL)
    for a, r in zip(ts + tt, list(gs) + list(gt)):
        r = np.asarray(r)
        np.testing.assert_allclose(a.grad.numpy(), r, rtol=TOL,
                                   atol=TOL * max(1.0, float(np.abs(r).max())))
