"""The port's optimizers (ssl_audio_tpu_torch/train/optim.py) against the JAX
package's through optax, on the CPU: three LARS steps over 1-D and n-D
parameters (a zero-norm parameter and a zero gradient included), with the
LR schedule on and off, and AdamW's decay mask."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.train import optim as jax_optim
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.train import optim
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5   # a handful of fp32 elementwise operations per step


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"conv": f(4, 1, 3, 3), "dense": f(6, 5), "bias": f(6), "scale": 1.0 + 0.1 * f(4),
            "zero_w": np.zeros((3, 2), np.float32), "zero_b": np.zeros(3, np.float32)}


def make_grads(step, params):
    rng = np.random.default_rng(100 + step)
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    g["dense"] = np.zeros_like(g["dense"]) if step == 1 else g["dense"]   # zero update norm
    return g


def run_both(cfg_kw, jax_tx_fn, torch_opt_fn, steps=3):
    params = make_params()
    jcfg, cfg = jax_config(**cfg_kw), default_config(**cfg_kw)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = jax_tx_fn(jcfg, jparams)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt, sched = torch_opt_fn(cfg, tparams.values())
    for step in range(steps):
        grads = make_grads(step, params)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        if sched is not None:
            sched.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), jparams[k], atol=TOL, rtol=TOL,
                                       err_msg=f"{k} after step {step}")
    return opt, opt_state, tparams


@pytest.mark.parametrize("lr_schedule", [False, True])
def test_three_lars_steps_match_optax(lr_schedule):
    # epochs 200 x 2 steps: two warm-up steps (factor 0, then 1.5), then the cosine
    kw = dict(dataset="synthetic", batch_size=384, epochs=200, lr_schedule=lr_schedule, wd=0.01)
    opt, opt_state, tparams = run_both(
        kw, lambda c, p: jax_optim.make_optimizer(c, p, 1),
        lambda c, ps: optim.make_optimizer(c, ps, 1))
    assert isinstance(opt, optim.LARS) and opt.count == int(opt_state.count) == 3
    for k, p in tparams.items():
        np.testing.assert_allclose(opt.state[p]["mu"].numpy(), opt_state.mu[k],
                                   atol=TOL, rtol=TOL, err_msg=f"momentum {k}")
    # a zero-norm n-D parameter moved by its raw gradient (trust ratio 1);
    # 1-D parameters skipped decay and the trust ratio
    assert float(tparams["zero_w"].detach().abs().max()) > 0


def test_lr_factor_matches_jax_over_warmup_and_cosine():
    kw = dict(dataset="synthetic", batch_size=256, epochs=300, lr_schedule=True)
    f_jax = jax_optim.lr_factor_fn(jax_config(**kw), 7)
    f = optim.lr_factor_fn(default_config(**kw), 7)
    for step in (0, 1, 20, 21, 22, 500, 2100, 2624, 2625, 4000):
        np.testing.assert_allclose(f(step), float(f_jax(step)), rtol=1e-5, atol=1e-7)
    assert optim.lr_factor_fn(default_config(dataset="synthetic"), 7)(123) == 1.0


ADAM_KW = dict(dataset="synthetic", lr=1e-2, wd=0.1, lr_schedule=True, epochs=200,
               batch_size=256)


def masked_adamw(cfg, params):
    """optax.adamw with the JAX package's own ndim > 1 mask (_no_wd_mask),
    kept static under inject_hyperparams."""
    factor = jax_optim.lr_factor_fn(cfg, 1)
    return optax.inject_hyperparams(optax.adamw, static_args=("mask",))(
        learning_rate=lambda step: cfg.lr * factor(step), weight_decay=cfg.wd,
        mask=jax_optim._no_wd_mask)


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_adam_family_matches_optax_with_the_ndim_decay_mask(name):
    """Adam and SGD against the JAX package's make_optimizer; AdamW against
    optax.adamw with the package's ndim > 1 mask applied as a mask (see the
    next test for why not through make_optimizer)."""
    kw = dict(ADAM_KW, optimizer=name)
    jax_tx = masked_adamw if name == "AdamW" else \
        (lambda c, p: jax_optim.make_optimizer(c, p, 1))
    opt, _, tparams = run_both(kw, jax_tx, lambda c, ps: optim.make_optimizer(c, ps, 1))
    if name == "AdamW":
        decays = {g["weight_decay"]: {p.ndim for p in g["params"]} for g in opt.param_groups}
        assert decays == {0.1: {2, 4}, 0.0: {1}}


def test_jax_make_optimizer_adamw_decays_nothing():
    """Pins a fault of the reference, not of the port: make_optimizer hands
    its mask function to optax.inject_hyperparams without static_args, which
    calls it as a schedule on the step count, so the mask is False everywhere
    and no parameter is decayed.  The port decays ndim > 1, the documented
    rule; against the JAX package's AdamW it agrees only at wd = 0."""
    kw = dict(ADAM_KW, optimizer="AdamW")
    run_both(kw, lambda c, p: jax_optim.make_optimizer(c, p, 1),
             lambda c, ps: optim.make_optimizer(c.replace(wd=0.0), ps, 1))
    with pytest.raises(AssertionError):
        run_both(kw, lambda c, p: jax_optim.make_optimizer(c, p, 1),
                 lambda c, ps: optim.make_optimizer(c, ps, 1))


def test_unknown_optimizer_and_missing_lr_raise():
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError):
        optim.make_optimizer(default_config(dataset="synthetic").replace(optimizer="Lion"),
                             params, 1)
    with pytest.raises(ValueError):        # a conv encoder has no default --lr
        optim.make_optimizer(default_config(dataset="synthetic", optimizer="AdamW"), params, 1)
