"""Data parallelism of the port (ssl_audio_tpu_torch/parallel, --distributed):
each module that reduces over the batch, run on two gloo ranks on the CPU,
against the JAX package on the global batch; the ranks against each other
bit for bit; the sharded loader's rows; main under --distributed with its
checkpoints and resume; the flags' refusals.

The two ranks are processes of one torch.multiprocessing.spawn for the
whole module (tests/torch_dist_worker.py): every check takes the global
batch, made here from numpy seeds, keeps its rank's contiguous rows, and
hands back numpy.  The gradient convention (parallel/__init__.py): a
rank's backward of a replicated global loss L gives its share of the
gradient of W L, so a parameter's gradient summed over the ranks of a loss
that is a sum over rows (the BatchNorm and fused-block checks) is the JAX
gradient, and a row's gradient of the replicated Barlow Twins loss is W
times JAX's.

Tolerance 1e-4 (fp32, BASELINE.md) relative to each tensor's largest value:
the ranks' sums and the correlation are taken in another order than one
process's."""
import glob

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.augment import augmentations as JA
from ssl_audio_tpu.data.pipeline import DataLoader as JaxDataLoader
from ssl_audio_tpu.objectives.barlow import barlow_twins_loss as jax_bt_loss
from ssl_audio_tpu.ops.fused_conv import fused_conv1_bn_relu_pool as jax_fused_block
from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.config import config_from_args, default_config, require_supported
from ssl_audio_tpu_torch.data.datasets import SyntheticLMS
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.ops.fused_attention import fused_attention
from tests import torch_dist_worker as worker
from tests.test_torch_fused_conv import make_inputs
from tests.test_torch_multi_dispatch import assert_tree_equal

TOL = 1e-4
W = worker.WORLD
B = 8                      # the global batch: 4 rows a rank
EPS = 1e-5
MAIN = ["--device", "cpu", "--dataset", "synthetic_wav", "--batch_size", "8", "--epochs", "2",
        "--synthetic_steps_per_epoch", "2", "--crop_frames", "32", "--projector_hidden_dim",
        "64", "--projector_out_dim", "32", "--num_workers", "1", "--mixup_n_memory", "16",
        "--epoch_save_f", "1", "--no_eval"]


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch thread per test (tests/test_torch_checkpoint.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, what, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol, err_msg=what)


def joined(results, key):
    """The ranks' rows of `key`, concatenated in rank order."""
    return np.concatenate([r[key] for r in results])


def summed(results, key):
    return sum(r[key].astype(np.float64) for r in results)


# ---------------------------------------------------------------- the inputs

def bn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[1]
    return dict(x=(1.5 * rng.standard_normal(shape) + 0.7).astype(np.float32),
                dy=rng.standard_normal(shape).astype(np.float32),
                weight=(1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
                bias=(0.3 * rng.standard_normal(C)).astype(np.float32),
                running_mean=(0.1 * rng.standard_normal(C)).astype(np.float32),
                running_var=(1 + 0.2 * np.abs(rng.standard_normal(C))).astype(np.float32))


def block_inputs():
    rng = np.random.default_rng(3)
    x, kernel, bias, gamma, beta = make_inputs(rng, B=B)
    dpooled = rng.standard_normal((B, 8, 12, 64)).astype(np.float32)
    return dict(x=x, kernel=kernel, bias=bias, gamma=gamma, beta=beta, dpooled=dpooled)


def bt_inputs(hsic):
    rng = np.random.default_rng(4)
    return dict(students=[rng.standard_normal((B, 24)).astype(np.float32) for _ in range(2)],
                teachers=[rng.standard_normal((B, 24)).astype(np.float32)], HSIC=hsic)


MIXUP_KEYS = (11, 12)
MIXUP_MEMORY = 12          # not a multiple of B: the second write wraps


def mixup_inputs():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((B, 1, 8, 6)).astype(np.float32) for _ in MIXUP_KEYS]
    alphas, us = [], []
    for k in MIXUP_KEYS:
        k_alpha, k_idx = jax.random.split(jax.random.key(k))
        alphas.append(np.asarray(0.2 * jax.random.uniform(k_alpha, (B, 1, 1, 1))))
        us.append(np.asarray(jax.random.uniform(k_idx, (B,))))
    return dict(xs=xs, alphas=alphas, us=us, n_memory=MIXUP_MEMORY)


def attention_inputs():
    rng = np.random.default_rng(6)
    N, C = 7, 32
    key_bias = np.where(rng.random((B, N)) < 0.4, -1e9, 0.0).astype(np.float32)
    key_bias[:, 0] = 0.0
    return dict(qkv=rng.standard_normal((B, N, 3 * C)).astype(np.float32), key_bias=key_bias,
                dout=rng.standard_normal((B, N, C)).astype(np.float32), heads=2)


INPUTS = {
    "batchnorm#2d": lambda: bn_inputs((B, 6, 4, 5), 1),
    "batchnorm#1d": lambda: bn_inputs((B, 10), 2),
    "fused_block": block_inputs,
    "bt_loss#plain": lambda: bt_inputs(False),
    "bt_loss#hsic": lambda: bt_inputs(True),
    "mixup": mixup_inputs,
    "attention": attention_inputs,
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every check and of two main runs (2 epochs,
    and resumed from the first one's model_1.pt), and the inputs."""
    out = tmp_path_factory.mktemp("dist")
    inputs = {name: make() for name, make in INPUTS.items()}
    work = out / "work"
    work.mkdir()
    checks = list(inputs.items()) + [
        ("main:full", dict(argv=[*MAIN, "--save_base_dir", "a"], cwd=str(work))),
        ("main:resumed", dict(argv=[*MAIN, "--save_base_dir", "r"], cwd=str(work),
                              resume_glob="a/results/synthetic_wav/*/model_1.pt")),
        ("main:windows", dict(argv=[*MAIN, "--save_base_dir", "w", "--steps_per_dispatch",
                                    "2"], cwd=str(work))),
    ]
    results = worker.spawn({"checks": checks}, str(out))
    return inputs, results, work


# ---------------------------------------------------------------- the checks

def flax_batchnorm(inp):
    """flax BatchNorm (momentum 0.9) in training mode on the global batch,
    channels last: (out, dx, dscale, dbias, new mean, new var), channels at
    axis 1 as the port's."""
    x = inp["x"] if inp["x"].ndim == 2 else inp["x"].transpose(0, 2, 3, 1)
    dy = inp["dy"] if inp["dy"].ndim == 2 else inp["dy"].transpose(0, 2, 3, 1)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=EPS)
    stats = {"mean": jnp.asarray(inp["running_mean"]), "var": jnp.asarray(inp["running_var"])}

    def f(x_, params):
        out, mut = mod.apply({"params": params, "batch_stats": stats}, x_,
                             mutable=["batch_stats"])
        return out, mut["batch_stats"]

    params = {"scale": jnp.asarray(inp["weight"]), "bias": jnp.asarray(inp["bias"])}
    out, vjp, new = jax.vjp(f, jnp.asarray(x), params, has_aux=True)
    dx, dparams = vjp(jnp.asarray(dy))
    back = (lambda a: a) if x.ndim == 2 else (lambda a: np.asarray(a).transpose(0, 3, 1, 2))
    return (back(np.asarray(out)), back(np.asarray(dx)), np.asarray(dparams["scale"]),
            np.asarray(dparams["bias"]), np.asarray(new["mean"]), np.asarray(new["var"]))


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_sync_batchnorm_matches_flax_on_the_global_batch(ranks, kind):
    """Output, input gradient, parameter gradients (summed over the ranks)
    and running buffers of models/batchnorm.py under two ranks."""
    inputs, results, _ = ranks
    inp, res = inputs[f"batchnorm#{kind}"], [r[f"batchnorm#{kind}"] for r in results]
    out, dx, dscale, dbias, mean, var = flax_batchnorm(inp)
    close(joined(res, "out"), out, "out")
    close(joined(res, "dx"), dx, "dx")
    close(summed(res, "dweight"), dscale, "dweight")
    close(summed(res, "dbias"), dbias, "dbias")
    for r in res:
        close(r["running_mean"], mean, "running_mean")
        close(r["running_var"], var, "running_var")
    assert np.array_equal(res[0]["running_var"], res[1]["running_var"])
    # the local statistics would differ: the reduction crossed the ranks
    local = inp["x"][:B // W].reshape(B // W, inp["x"].shape[1], -1)
    assert not np.allclose(0.9 * inp["running_mean"] + 0.1 * local.mean(axis=(0, 2)),
                           res[0]["running_mean"], atol=1e-3)


def test_fused_block_function_matches_jax_on_the_global_batch(ranks):
    """The fused block's autograd Function: pooled rows, the global mean and
    var, dx rows, and dW, db, dgamma, dbeta summed over the ranks, against
    the JAX Pallas block (interpret mode) and its custom_vjp."""
    inputs, results, _ = ranks
    inp, res = inputs["fused_block"], [r["fused_block"] for r in results]
    args = [jnp.asarray(inp[k]) for k in ("x", "kernel", "bias", "gamma", "beta")]
    (pooled, mean, var), vjp = jax.vjp(jax_fused_block, *args)
    grads = vjp((jnp.asarray(inp["dpooled"]), jnp.zeros_like(mean), jnp.zeros_like(var)))
    close(joined(res, "pooled"), pooled, "pooled")
    for r in res:
        close(r["mean"], mean, "mean")
        close(r["var"], var, "var")
    close(joined(res, "dx"), grads[0], "dx")
    for name, g in zip(("dkernel", "dbias", "dgamma", "dbeta"), grads[1:]):
        # db is 0 up to float noise: held against the scale of dW
        tol_ref = grads[1] if name == "dbias" else g
        scale = max(1.0, float(np.abs(np.asarray(tol_ref)).max()))
        np.testing.assert_allclose(summed(res, name), np.asarray(g, np.float64),
                                   atol=TOL * scale, rtol=TOL, err_msg=name)
    for k in ("mean", "var"):
        assert np.array_equal(res[0][k], res[1][k])


@pytest.mark.parametrize("hsic", ["plain", "hsic"])
def test_bt_loss_over_the_global_batch_with_world_scale(ranks, hsic):
    """The loss with world_scale = W reads JAX's on the global batch on both
    ranks, bit for bit alike; a row's gradient is W times JAX's."""
    inputs, results, _ = ranks
    inp, res = inputs[f"bt_loss#{hsic}"], [r[f"bt_loss#{hsic}"] for r in results]
    kw = dict(HSIC=inp["HSIC"], world_scale=float(W))
    loss, (gs, gt) = jax.value_and_grad(lambda s, t: jax_bt_loss(s, t, **kw), argnums=(0, 1))(
        inp["students"], inp["teachers"])
    assert res[0]["loss"] == res[1]["loss"]
    np.testing.assert_allclose(res[0]["loss"], float(loss), rtol=TOL)
    for key, want in (("dstudents", gs), ("dteachers", gt)):
        for i, g in enumerate(want):
            close(np.concatenate([r[key][i] for r in res]), W * np.asarray(g), f"{key}[{i}]")


def test_mixup_bank_is_written_with_the_global_batch(ranks):
    """Two calls of apply_mixup: the mixed rows, and the bank, count and
    position (the second write wraps), against JAX's mixup_byola on the
    global batch from the same keys."""
    inputs, results, _ = ranks
    inp, res = inputs["mixup"], [r["mixup"] for r in results]
    state = JA.init_mixup_state(MIXUP_MEMORY, inp["xs"][0].shape[1:])
    for i, (k, x) in enumerate(zip(MIXUP_KEYS, inp["xs"])):
        mixed, state = JA.mixup_byola(jax.random.key(k), jnp.asarray(x), state)
        close(np.concatenate([r[i]["mixed"] for r in res]), mixed, f"mixed {i}")
        for r in res:
            assert np.array_equal(r[i]["bank"], np.asarray(state.bank)), f"bank {i}"
            assert (r[i]["count"], r[i]["pos"]) == (int(state.count), int(state.pos))
    assert int(state.count) == MIXUP_MEMORY and int(state.pos) == 2 * B % MIXUP_MEMORY


def test_fused_attention_crosses_no_rank(ranks):
    """Attention is per row: each rank's output and gradients are its rows
    of one process's call on the global batch, bit for bit."""
    inputs, results, _ = ranks
    inp, res = inputs["attention"], [r["attention"] for r in results]
    qkv = torch.from_numpy(inp["qkv"]).requires_grad_(True)
    kb = torch.from_numpy(inp["key_bias"]).requires_grad_(True)
    out = fused_attention(qkv, kb, inp["heads"])
    (out * torch.from_numpy(inp["dout"])).sum().backward()
    assert np.array_equal(joined(res, "out"), out.detach().numpy())
    assert np.array_equal(joined(res, "dqkv"), qkv.grad.numpy())
    assert np.array_equal(joined(res, "dbias"), kb.grad.numpy())


def test_main_distributed_resumes_bit_for_bit(ranks):
    """main --distributed on two ranks (global batch 8, 4 rows a rank):
    rank 0 wrote the checkpoints and the log; a run resumed from model_1.pt
    ends where the uninterrupted one does, bit for bit, on both ranks; the
    ranks hold one replica."""
    _, results, work = ranks
    full, resumed = [r["main:full"] for r in results], [r["main:resumed"] for r in results]
    assert all(r["batch_rows"] == 4 for r in full)
    assert glob.glob(str(work / "a/results/synthetic_wav/*/model_2.pt"))
    assert glob.glob(str(work / "logs/training/synthetic_wav/*/log.csv"))
    for f, r in zip(full, resumed):
        assert r["losses"] == {2: f["losses"][2]}
        assert_tree_equal(r["state"], f["state"])
    assert full[0]["losses"] == full[1]["losses"]
    assert_tree_equal(full[0]["state"], full[1]["state"])


def test_main_distributed_windows_are_single_steps(ranks):
    """--steps_per_dispatch 2 under --distributed (windows run eagerly on
    the CPU; on the card a window's graph holds the all-reduces): both
    epochs and the final state as one step a dispatch, bit for bit."""
    _, results, _ = ranks
    for r in results:
        assert r["main:windows"]["losses"] == r["main:full"]["losses"]
        assert_tree_equal(r["main:windows"]["state"], r["main:full"]["state"])


# -------------------------------------------------- the loader and the flags

def test_sharded_loader_yields_rows_of_the_global_batch():
    """process_index / process_count as in JAX: rank r's batch is rows
    [r B/W, (r+1) B/W) of the one-process batch of B, the same rows the JAX
    loader gives that rank; the length counts global batches."""
    cfg = default_config(dataset="synthetic", crop_frames=8, n_mels=8)
    ds = SyntheticLMS(cfg, length=40, seed=3)
    one = list(DataLoader(ds, B, num_workers=1, seed=7))
    shards = [list(DataLoader(ds, B // W, num_workers=1, seed=7, process_index=r,
                              process_count=W)) for r in range(W)]
    theirs = [list(JaxDataLoader(ds, B // W, num_workers=1, seed=7, process_index=r,
                                 process_count=W)) for r in range(W)]
    assert len(one) == len(shards[0]) == 5
    for b, (xs, ys) in enumerate(one):
        assert np.array_equal(np.concatenate([s[b][0] for s in shards]), xs)
        assert np.array_equal(np.concatenate([s[b][1] for s in shards]), ys)
        for r in range(W):
            assert np.array_equal(shards[r][b][0], theirs[r][b][0])
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(ds, 4, drop_last=False, process_count=2)


def test_distributed_needs_torchrun_and_a_card(monkeypatch, tmp_path):
    """--distributed without torchrun's environment raises and names
    torchrun, before anything is written; with it but without a card and
    without --device cpu it raises too; nothing runs in one process
    instead."""
    from ssl_audio_tpu_torch import main

    for k in parallel.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torchrun"):
        main.main([*MAIN, "--distributed"])
    assert not any(tmp_path.iterdir())
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.init_distributed(default_config(distributed=True))
    assert not parallel.is_distributed()


@pytest.mark.parametrize("world,axis,ok", [(None, 0, True), (None, 1, True), (None, 3, False),
                                           ("2", 2, True), ("2", 0, True), ("2", 4, False)])
def test_data_axis_size_is_zero_or_the_world_size(monkeypatch, world, axis, ok):
    """--data_axis_size: 0 or W (W = 1 without --distributed); anything
    else is refused and names torchrun.  Tensor parallelism and FSDP stay
    refused under --distributed."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--data_axis_size", str(axis)]
    if world:
        monkeypatch.setenv("WORLD_SIZE", world)
        argv.append("--distributed")
    cfg = config_from_args(argv)
    if ok:
        require_supported(cfg)
        for extra in (["--model_parallel", "2"], ["--fsdp"]):
            with pytest.raises(NotImplementedError, match="not ported yet"):
                require_supported(config_from_args(argv + extra))
    else:
        with pytest.raises(NotImplementedError, match="torchrun"):
            require_supported(cfg)
