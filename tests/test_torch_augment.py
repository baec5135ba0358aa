"""The port's augmentations (ssl_audio_tpu_torch/augment) against the JAX
package's on the CPU.  The two frameworks never draw the same numbers, so
the random parameters are drawn on the JAX side, from the keys the JAX
function itself derives (the same splits, replayed here), and handed to the
port's deterministic apply functions.  Inputs come from numpy with a seed.
fp32 tolerance 1e-4 (BASELINE.md) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.augment import augmentations as JA
from ssl_audio_tpu.augment import transforms as JT
from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu_torch.augment import augmentations as A
from ssl_audio_tpu_torch.augment import transforms as T
from ssl_audio_tpu_torch.config import default_config
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4
GLOBAL = dict(freq_scale=(0.6, 1.5), time_scale=(0.6, 1.5))
LOCAL = dict(freq_scale=(0.05, 0.6), time_scale=(0.05, 0.6))


def t(a):
    return torch.from_numpy(np.array(a))


# --- the JAX package's draws, replayed from its keys -------------------------

def jax_crop_boxes(key, B, in_size, virtual_crop_scale, freq_scale, time_scale):
    """(i, j, h, w) as _rrc_single draws them for each of B samples."""
    F_in, T_in = in_size
    ch, cw = int(F_in * virtual_crop_scale[0]), int(T_in * virtual_crop_scale[1])

    def one(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        h = jnp.clip(jnp.floor(jax.random.uniform(
            k1, (), minval=freq_scale[0], maxval=freq_scale[1]) * F_in), 1, ch)
        w = jnp.clip(jnp.floor(jax.random.uniform(
            k2, (), minval=time_scale[0], maxval=time_scale[1]) * T_in), 1, cw)
        i = jnp.floor(jax.random.uniform(k3, ()) * (ch - h + 1.0))
        j = jnp.floor(jax.random.uniform(k4, ()) * (cw - w + 1.0))
        return i, j, h, w

    return A.CropBoxes(*(t(v) for v in jax.vmap(one)(jax.random.split(key, B))))


def jax_mixup_draws(key, B, ratio):
    k_alpha, k_idx = jax.random.split(key)
    return (t(ratio * jax.random.uniform(k_alpha, (B, 1, 1, 1))),
            t(jax.random.uniform(k_idx, (B,))))


def jax_noise_draws(key, shape, ratio=0.2):
    k_l, k_n = jax.random.split(key)
    return (t(ratio * jax.random.uniform(k_l, (shape[0], 1, 1, 1))),
            t(jax.random.normal(k_n, shape)))


def jax_fader_draws(key, B, gain=1.0):
    return t(gain * (2.0 * jax.random.uniform(key, (B, 2)) - 1.0))


def jax_pair_draws(key, cfg, shape) -> T.PairDraws:
    """What make_pair_views(key, ...) draws, as the port's PairDraws."""
    B = shape[0]
    keys = jax.random.split(key, 2 + cfg.local_crops_number)
    views = []
    for k in keys[:2]:
        k_mix, k_noise, k_rrc, k_rlf = jax.random.split(k, 4)
        d = T.GlobalDraws()
        if cfg.mixup:
            d.mix = jax_mixup_draws(k_mix, B, cfg.mixup_ratio)
        if cfg.Gnoise:
            d.noise = jax_noise_draws(k_noise, shape)
        if cfg.RRC:
            d.boxes = jax_crop_boxes(k_rrc, B, shape[-2:], tuple(cfg.virtual_crop_scale),
                                     **GLOBAL)
        if cfg.RLF:
            d.fader = jax_fader_draws(k_rlf, B)
        views.append(d)
    local = [jax_crop_boxes(k, B, shape[-2:], (1.0, 1.0), **LOCAL) for k in keys[2:]]
    return T.PairDraws(globals=views, local_boxes=local)


# --- tests ----------------------------------------------------------------------

def lms_batch(seed, shape=(4, 1, 64, 32)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_cubic_weights_sum_to_one():
    tt = torch.linspace(0, 0.999, 50)
    w = A._cubic_weights(tt)
    np.testing.assert_allclose(w.numpy(), JA._cubic_weights(jnp.asarray(tt.numpy())),
                               atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("start,extent", [(0.0, 10.0), (38.0, 10.0), (0.0, 48.0),
                                          (47.0, 1.0), (5.0, 30.0)])
def test_interp_matrix_matches_jax_at_canvas_edges(start, extent):
    """Boxes at the left edge, the right edge, the whole canvas, a
    one-column box at the last column, and an inner box: taps clamp to the
    crop, never outside it."""
    ours = A._interp_matrix(16, 48, torch.tensor([start]), torch.tensor([extent]))[0]
    ref = JA._interp_matrix(16, 48, jnp.float32(start), jnp.float32(extent))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    inside = torch.zeros(48, dtype=torch.bool)
    inside[int(start):int(start + extent)] = True
    assert float(ours[:, ~inside].abs().max() if (~inside).any() else 0.0) == 0.0


def test_random_resize_crop_apply_matches_jax():
    x = lms_batch(1)
    key = jax.random.key(3)
    ref = JA.random_resize_crop(key, jnp.asarray(x), (64, 32), (1.0, 1.5),
                                (0.6, 1.5), (0.6, 1.5))
    boxes = jax_crop_boxes(key, 4, (64, 32), (1.0, 1.5), **GLOBAL)
    ours = A.resize_bicubic_crop(t(x), boxes, (64, 32), (1.0, 1.5))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=TOL)
    # the JAX package's deterministic twin on one sample
    one = JA.resize_bicubic_crop(jnp.asarray(x[0]), 3, 5, 40, 20, (64, 32), (1.0, 1.5))
    box = A.CropBoxes(*(torch.tensor([v]) for v in (3.0, 5.0, 40.0, 20.0)))
    np.testing.assert_allclose(A.resize_bicubic_crop(t(x[:1]), box, (64, 32))[0].numpy(),
                               one, atol=TOL, rtol=TOL)


def test_draw_crop_boxes_stay_on_the_canvas():
    gen = torch.Generator().manual_seed(0)
    b = A.draw_crop_boxes(gen, 512, (64, 96), (1.0, 1.5), **GLOBAL)
    assert float(b.h.min()) >= 38 and float(b.h.max()) <= 64
    assert float(b.w.min()) >= 57 and float(b.w.max()) <= 144
    assert float((b.i + b.h).max()) <= 64 and float((b.j + b.w).max()) <= 144
    assert float(b.i.min()) >= 0 and float(b.j.min()) >= 0
    assert all(torch.equal(v, v.floor()) for v in b)


@pytest.mark.parametrize("filled", [False, True])
def test_mixup_apply_matches_jax(filled):
    """An empty bank passes the input through; then both write the batch."""
    x = lms_batch(2)
    n_mem = 8
    jstate = JA.init_mixup_state(n_mem, x.shape[1:])
    ours = A.init_mixup_state(n_mem, x.shape[1:])
    if filled:
        # one earlier batch: the write position advances by whole batches
        old = lms_batch(3, (4,) + x.shape[1:])
        jstate = JA.MixupState(bank=jstate.bank.at[:4].set(old), count=jnp.int32(4),
                               pos=jnp.int32(4))
        ours.bank[:4] = t(old)
        ours.count.fill_(4)           # the ring's count and position are device tensors
        ours.pos.fill_(4)
    key = jax.random.key(5)
    ref, jnew = JA.mixup_byola(key, jnp.asarray(x), jstate, ratio=0.2)
    alpha, u = jax_mixup_draws(key, 4, 0.2)
    idx = torch.floor(u * max(int(ours.count), 1)).long()
    out = A.apply_mixup(t(x), ours, alpha, idx)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    if not filled:
        assert torch.equal(out, t(x))
    np.testing.assert_array_equal(ours.bank.numpy(), jnew.bank)
    assert (ours.count, ours.pos) == (int(jnew.count), int(jnew.pos))


def test_mixup_bank_smaller_than_batch_is_an_error():
    with pytest.raises(ValueError):
        A.apply_mixup(torch.zeros(4, 1, 2, 2), A.init_mixup_state(2, (1, 2, 2)),
                      torch.zeros(4, 1, 1, 1), torch.zeros(4, dtype=torch.long))
    cfg = default_config(dataset="synthetic", batch_size=8, mixup_n_memory=4)
    with pytest.raises(ValueError):
        T.init_augment_state(cfg)


def test_fader_noise_normalize_match_jax():
    x = lms_batch(4)
    key = jax.random.key(7)
    np.testing.assert_allclose(
        A.apply_linear_fader(t(x), jax_fader_draws(key, 4)).numpy(),
        JA.random_linear_fader(key, jnp.asarray(x)), atol=1e-5)
    np.testing.assert_allclose(
        A.apply_gaussian_noise(t(x), *jax_noise_draws(key, x.shape)).numpy(),
        JA.mix_gaussian_noise(key, jnp.asarray(x)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(A.normalize_batch(t(x)).numpy(),
                               JA.normalize_batch(jnp.asarray(x)), atol=1e-5)
    np.testing.assert_allclose(
        A.log_mixup_exp(t(x), t(x[::-1].copy()), torch.tensor(0.3)).numpy(),
        JA.log_mixup_exp(jnp.asarray(x), jnp.asarray(x[::-1].copy()), 0.3), atol=1e-5)


def test_running_norm_matches_jax_over_three_calls():
    jstate = JA.init_running_norm_state((1, 1, 1, 1))
    ours = A.init_running_norm_state((1, 1, 1, 1))
    for step, max_update in enumerate((10, 10, 2)):       # the third call is frozen
        x = 3.0 + 2.0 * lms_batch(10 + step)
        ref, jstate = JA.running_norm(jnp.asarray(x), jstate, max_update, axis=(0, 1, 2, 3))
        out = A.running_norm(t(x), ours, max_update, dim=(0, 1, 2, 3))
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert ours.n == int(jstate.n) == 2


@pytest.mark.parametrize("options", [
    dict(),                                                # mixup + RRC + RLF (the default)
    dict(Gnoise=True, post_norm=True, local_crops_number=2),
    dict(pre_norm=True, mixup=False),
])
def test_two_consecutive_make_pair_views_match_jax(options):
    """Bank empty at the first call, filled at the second: view 1 writes the
    batch once, view 2 reads the updated bank."""
    kw = dict(dataset="synthetic", batch_size=4, crop_frames=32, mixup_n_memory=8,
              **options)
    jcfg, cfg = jax_config(**kw), default_config(**kw)
    jstate, state = JT.init_augment_state(jcfg), T.init_augment_state(cfg)
    for step in range(2):
        x = lms_batch(20 + step)
        key = jax.random.key(step)
        ref, jstate = JT.make_pair_views(key, jnp.asarray(x), jstate, jcfg)
        views = T.apply_pair_views(t(x), state, cfg, jax_pair_draws(key, cfg, x.shape))
        assert len(views) == len(ref) == 2 + cfg.local_crops_number
        for v, r in zip(views, ref):
            np.testing.assert_allclose(v.numpy(), r, atol=TOL, rtol=TOL)
        if cfg.mixup:
            np.testing.assert_array_equal(state.mixup.bank.numpy(), jstate.mixup.bank)
            assert state.mixup.count == int(jstate.mixup.count) == 4 * (step + 1)


def test_make_pair_views_draws_on_its_generator():
    cfg = default_config(dataset="synthetic", batch_size=4, crop_frames=32)
    x = t(lms_batch(30))
    outs = []
    for _ in range(2):
        state = T.init_augment_state(cfg)
        outs.append(T.make_pair_views(torch.Generator().manual_seed(9), x, state, cfg))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert outs[0][0].shape == (4, 1, 64, 32) and not torch.equal(outs[0][0], outs[0][1])
