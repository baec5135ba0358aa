"""The JAX package's Orbax checkpoints in the port and back, on the CPU at
small sizes: utils/orbax.py read_orbax_tree, the grafts of utils/weights.py,
load_encoder_checkpoint (linear, evaluate), tools/convert_checkpoint.py
(--to pt, --to pth) and the resume of a converted file (a step against
JAX's next step; the legacy trainer).

The JAX package writes every directory with its own save_checkpoint /
save_params_only / tools.  Its states are perturbed first (parameters,
running statistics, optimizer moments, the mixup ring, the counters), so
that a mapping that drops or swaps a tensor shows.  Tolerances: the state
dicts bit for bit; an optimizer step from the converted state 1e-5 of the
step taken (relative L2: the same fp32 update in another order) plus the
parameters' own fp32 spacing (each side rounds its new parameter); the
resumed training step at the train-step tests' own tolerances
(tests/test_torch_train_step.py)."""
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train import legacy_steps as jlegacy
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import init_monitor as jax_init_monitor
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu.utils import checkpoint as jckpt
from ssl_audio_tpu_torch import evaluate, linear
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.main_pretrain import LegacyTrainer
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.tools import convert_checkpoint as convert
from ssl_audio_tpu_torch.train.legacy_steps import init_legacy_state
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import init_monitor, make_train_step
from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib
from ssl_audio_tpu_torch.utils import weights as W
from ssl_audio_tpu_torch.utils.orbax import is_orbax_dir, read_orbax_tree
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_train_step import KW as STEP_KW
from tests.test_torch_train_step import TOL, compare_states, port_draws

SMALL = dict(dataset="synthetic", batch_size=4, crop_frames=32, projector_hidden_dim=64,
             projector_out_dim=32, mixup_n_memory=8, seed=0)
# one state per layout the JAX loaders read: (method, config)
CASES = {
    # the resumed-step test's configuration (tests/test_torch_train_step.py KW
    # on log-mels), so that both use one JAX initial state
    "lars_audiontt": (None, dict(STEP_KW, dataset="synthetic")),
    "adamw_vit": (None, dict(SMALL, model_type="vit_tiny")),
    "byol_lars": ("byol", dict(SMALL, predictor=True)),
    "dino": ("dino", dict(SMALL, dino_out_dim=32, warmup_epochs=0, epochs=2)),
    "byola": ("byola", dict(SMALL, proj_dim=64, proj_size=16)),
}
STEP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def narrow_vit():
    """Both packages' "tiny" ViT at width 64, depth 2, 4 heads."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "_SIZES", {"tiny": (64, 2, 4)})
        mp.setattr(vit, "_SIZES", {"tiny": (64, 2, 4)})
        yield


def argv_of(kw) -> list:
    out = []
    for k, v in kw.items():
        if v is True:
            out.append(f"--{k}")
        else:
            out += [f"--{k}", str(v)]
    return out


def perturbed(tree, seed: int, scale: float = 0.1):
    """Every float leaf moved upwards by |N(0, scale^2)| (variances and
    second moments stay positive), every integer leaf (the step, optimizer
    and schedule counts, the ring's count and position) set to 3; optax's
    hyperparams (b1, b2, eps, a constant weight decay: read from the state
    at every update) as they are."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        if any(getattr(k, "name", getattr(k, "key", None)) == "hyperparams" for k in path):
            return a
        a = np.asarray(a)
        if a.dtype.kind == "f":
            return (a + scale * np.abs(rng.standard_normal(a.shape, np.float32))).astype(a.dtype)
        return np.full_like(a, 3) if a.dtype.kind in "iu" else a

    return jax.tree_util.tree_map_with_path(f, tree)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


_STATES, _INITIAL = {}, {}


def jax_initial_state(method, kw):
    """The JAX package's initial train state of the case (init_legacy_state
    for dino / byola), jitted (flax's eager init compiles op by op, several
    times slower here) and made once per module."""
    key = (method, tuple(sorted(kw.items())))
    if key not in _INITIAL:
        legacy = method in ("dino", "byola")
        jcfg = jax_config(method=method if legacy else None, **kw)
        if legacy:
            fn = lambda k: jlegacy.init_legacy_state(jcfg, k, method, niter_per_ep=2)[1]  # noqa: E731
        else:
            fn = lambda k: jax_init_train_state(jcfg, k, niter_per_ep=2,  # noqa: E731
                                                byol=method == "byol")[1]
        _INITIAL[key] = jax.jit(fn)(jax.random.key(0))
    return _INITIAL[key]


def jax_case(name, tmp_path_factory):
    """(method, kw, perturbed JAX state, Orbax directory written by JAX's
    save_checkpoint at epoch 3), made once per module."""
    if name not in _STATES:
        method, kw = CASES[name]
        jstate = perturbed(jax_initial_state(method, kw), seed=len(_STATES))
        path = str(tmp_path_factory.mktemp(name) / "model_2")
        jckpt.save_checkpoint(path, jstate, 3)
        _STATES[name] = (method, kw, jstate, path)
    return _STATES[name]


def port_state(method, kw):
    """The port's state of the case, its schedules as long as JAX's (two
    iterations an epoch: tools/convert_checkpoint.py's state has one, since
    a checkpoint carries the schedules' position, not their length)."""
    legacy = method in ("dino", "byola")
    cfg = default_config(method=method if legacy else None, device="cpu", **kw)
    gen = torch.Generator().manual_seed(cfg.seed)
    if legacy:
        return init_legacy_state(cfg, gen, method, niter_per_ep=2, device="cpu")
    return init_train_state(cfg, gen, niter_per_ep=2, byol=method == "byol", device="cpu")


def zero_stats(tree):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {"mean": np.zeros_like(tree["scale"]), "var": np.zeros_like(tree["scale"])}
        return {k: zero_stats(v) for k, v in tree.items() if isinstance(v, dict)}
    return {}


def expected_model(jstate, method, spec):
    """*_from_jax applied to the in-memory JAX state, under the modules' names."""
    legacy = method in ("dino", "byola")

    def stack(params, stats, prefix=""):
        sds = (W.legacy_state_dicts_from_jax(as_np(params), as_np(stats), method, spec)
               if legacy else W.train_state_dicts_from_jax(as_np(params), as_np(stats), spec))
        return {f"{prefix}{m}.{k}": v for m, sd in sds.items() for k, v in sd.items()}

    out = stack(jstate.params, jstate.batch_stats)
    if jstate.target_params is not None:
        out.update(stack(jstate.target_params, jstate.target_batch_stats, "target."))
    return out


def expected_moments(mu, params, method, spec):
    """A JAX moment tree (shaped like the parameters, frozen ones None) under
    the parameters' names, by the same *_from_jax rules."""
    if isinstance(mu, (list, tuple)):
        a = expected_moments(mu[0], params[0], method, spec)
        b = expected_moments(mu[1], params[1], method, spec)
        return {**a, **{f"target.{k}": v for k, v in b.items()}}

    def frozen(x):                    # optax keeps no moment for a frozen parameter
        return x is None or type(x).__name__ == "MaskedNode"

    mu = jax.tree.map(lambda m, p: np.zeros(np.shape(p), np.float32) if frozen(m) else m,
                      mu, as_np(params), is_leaf=frozen)
    if method in ("dino", "byola"):
        sds = W.legacy_state_dicts_from_jax(mu, zero_stats(mu), method, spec)
    else:
        sds = W.train_state_dicts_from_jax(mu, zero_stats(mu), spec)
    return {f"{m}.{k}": v for m, sd in sds.items() for k, v in sd.items()}


def jax_moments(opt_state):
    """(count, mu, nu or None) of a JAX optimizer state."""
    found = []

    def visit(x):
        if hasattr(x, "mu"):
            found.append(x)
        elif hasattr(x, "inner_states"):
            visit(x.inner_states["train"])
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif hasattr(x, "inner_state"):
            visit(x.inner_state)

    visit(opt_state)
    assert len(found) == 1
    return int(found[0].count), found[0].mu, getattr(found[0], "nu", None)


def assert_equal_sd(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ----------------------------------------------------------------- the reader

def test_reader_reads_every_orbax_layout(tmp_path):
    """OCDBT or not, zarr v2 or v3: nested dicts, sequences as lists,
    scalars, None and empty containers, bf16 as torch.bfloat16; JAX's raw
    restore reads the same tree."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "s": 5,
            "b": {"c": jnp.full((3,), 1.5, jnp.bfloat16), "i": np.int32(-2)},
            "l": [np.ones(2), None], "e": {}}
    for ocdbt in (True, False):
        for zarr3 in (False, True):
            path = str(tmp_path / f"t{int(ocdbt)}{int(zarr3)}")
            ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=ocdbt, use_zarr3=zarr3)).save(
                path, tree)
            assert is_orbax_dir(path)
            got = read_orbax_tree(path)
            ref = ocp.PyTreeCheckpointer().restore(path)
            assert sorted(got) == sorted(ref) and got["s"] == ref["s"] == 5
            np.testing.assert_array_equal(got["a"], ref["a"])
            assert got["b"]["c"].dtype == torch.bfloat16
            assert torch.equal(got["b"]["c"].float(), torch.full((3,), 1.5))
            assert got["b"]["i"] == ref["b"]["i"] == -2        # a scalar leaf
            assert got["l"][1] is None and got["e"] == {}
            np.testing.assert_array_equal(got["l"][0], np.ones(2))
    with pytest.raises(ValueError, match="_METADATA"):
        read_orbax_tree(str(tmp_path))
    (tmp_path / "t10" / "_METADATA").write_text(json.dumps({"tree_metadata": {
        "('x',)": {"key_metadata": [{"key": "x", "key_type": 2}],
                   "value_metadata": {"value_type": "string"}}}}))
    with pytest.raises(ValueError, match="'string'"):
        read_orbax_tree(str(tmp_path / "t10"))


# ------------------------------------------------------------------- grafts

@pytest.mark.parametrize("name", list(CASES))
def test_whole_train_states_graft_bit_for_bit(name, tmp_path_factory):
    """The port's state from the Orbax directory equals *_from_jax applied
    to the JAX state in memory: every stack's parameters and statistics,
    the moments under each parameter's name, the counts, the LR schedule's
    position, the ring, the step, the DINO centre and the epoch."""
    method, kw, jstate, path = jax_case(name, tmp_path_factory)
    state = port_state(method, kw)
    sd, epoch = W.train_state_dict_from_jax(read_orbax_tree(path), state,
                                            method if method in ("dino", "byola") else None)
    state.load_state_dict(sd)
    enc = state.modules["encoder"]
    spec = enc.spec if hasattr(enc, "grid_size") else None
    assert epoch == 3 and state.step == 3
    assert_equal_sd(state.modules.state_dict(), expected_model(jstate, method, spec))
    count, mu, nu = jax_moments(jstate.opt_state)
    params = (jstate.params, jstate.target_params) if isinstance(mu, (list, tuple)) \
        else jstate.params
    want_mu = expected_moments(mu, params, method, spec)
    want_nu = None if nu is None else expected_moments(nu, params, method, spec)
    names = {id(p): n for n, p in state.modules.named_parameters()}
    n_held = 0
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st, n = state.optimizer.state[p], names[id(p)]
            if want_nu is None:
                assert torch.equal(st["mu"], want_mu[n]), n
            else:
                assert torch.equal(st["exp_avg"], want_mu[n]), n
                assert torch.equal(st["exp_avg_sq"], want_nu[n]), n
                assert float(st["step"]) == count
            n_held += 1
    assert n_held == len([p for p in state.modules.parameters() if p.requires_grad])
    if state.scheduler is not None:
        assert state.scheduler.state_dict()["last_epoch" if method is None else "count"] == 3
    elif want_nu is None:
        assert state.optimizer.count == 3
    np.testing.assert_array_equal(state.aug.mixup.bank.numpy(), jstate.aug.mixup.bank)
    assert int(state.aug.mixup.count) == int(state.aug.mixup.pos) == 3
    if method == "dino":
        np.testing.assert_array_equal(state.center.numpy(), jstate.extra["center"])


def test_a_checkpoint_of_another_optimizer_is_refused(tmp_path_factory):
    _, kw, _, path = jax_case("lars_audiontt", tmp_path_factory)
    state = port_state(None, dict(kw, optimizer="Adam", lr=1e-3))
    with pytest.raises(ValueError, match="optimizer is lars"):
        W.train_state_dict_from_jax(read_orbax_tree(path), state)


@pytest.mark.parametrize("name", ["adamw_vit", "dino", "byola"])
def test_an_optimizer_step_from_the_converted_state_matches_jax(name, tmp_path_factory):
    """The same gradients into JAX's optimizer (optax, from the state in
    memory) and the port's (from the converted file): the step each
    parameter takes agrees, so the moments, the count (Adam's bias
    correction) and the schedules' position came across."""
    method, kw, jstate, path = jax_case(name, tmp_path_factory)
    legacy = method in ("dino", "byola")
    jcfg = jax_config(method=method if legacy else None, **kw)
    from ssl_audio_tpu.train.optim import make_legacy_optimizer, make_optimizer

    tx = (make_legacy_optimizer(jcfg, method, 2) if legacy
          else make_optimizer(jcfg, jstate.params, 2))
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
                         as_np(jstate.params))
    updates, _ = jax.jit(tx.update)(grads, jstate.opt_state, jstate.params)
    import optax

    jafter = optax.apply_updates(jstate.params, updates)
    state = port_state(method, kw)
    sd, _ = W.train_state_dict_from_jax(read_orbax_tree(path), state,
                                        method if legacy else None)
    state.load_state_dict(sd)
    enc = state.modules["encoder"]
    spec = enc.spec if hasattr(enc, "grid_size") else None
    g = expected_moments(grads, jstate.params, method, spec)
    before = {n: p.detach().clone() for n, p in state.modules.named_parameters()}
    for n, p in state.modules.named_parameters():
        if p.requires_grad:
            p.grad = g[n]
    state.optimizer.step()
    want = expected_moments(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                         jafter, as_np(jstate.params)),
                            jstate.params, method, spec)
    if not legacy:
        # the port decays ndim > 1 parameters by lr * wd (the reference's rule);
        # the JAX package's inject_hyperparams AdamW calls its mask function
        # as a schedule and decays nothing (tests/test_torch_optim.py)
        assert not jcfg.lr_schedule
        for n, p in before.items():
            if p.ndim > 1:
                want[n] = want[n] - np.float32(jcfg.lr * jcfg.wd) * p
    moved = 0
    for n, p in state.modules.named_parameters():
        if not p.requires_grad or n.startswith("target."):
            continue
        took = (p.detach() - before[n]).double()
        ref = want[n].double()
        # each side's new parameter is rounded to fp32: one spacing of it each
        ulp = float(torch.from_numpy(np.spacing(before[n].abs().numpy())).double().norm())
        assert float((took - ref).norm()) <= STEP_RTOL * float(ref.norm()) + 2 * ulp, n
        moved += float(ref.norm()) > 0
    assert moved > 10


@pytest.mark.parametrize("layout", ["params_only", "imported"])
def test_encoder_layouts_load_through_load_encoder_checkpoint(layout, tmp_path_factory,
                                                              tmp_path):
    """A save_params_only tree (running statistics stay the model's own, as
    JAX keeps its template's) and the importer's tree (AudioNTT's
    params/encoder/encoder) graft the encoder; linear's load_model and
    evaluate read them the same way."""
    _, kw, jstate, _ = jax_case("lars_audiontt", tmp_path_factory)
    path = str(tmp_path / layout)
    if layout == "params_only":
        jckpt.save_params_only(path, jstate.params)
    else:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, {"params": {"encoder": as_np(jstate.params["encoder"])},
                          "batch_stats": {"encoder": as_np(jstate.batch_stats["encoder"])}})
        ckptr.wait_until_finished()
    want = W.encoder_state_dict_from_jax(as_np(jstate.params["encoder"]),
                                         as_np(jstate.batch_stats["encoder"]))
    cfg = default_config(device="cpu", **kw)
    fresh = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    enc = linear.load_model(cfg, path)
    for k, v in enc.state_dict().items():
        if layout == "params_only" and k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, fresh.modules["encoder"].state_dict()[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    seen = {}

    def train_classifier(cfg, encoder, *a, **k):
        seen.update({k: v.clone() for k, v in encoder.state_dict().items()})
        return None, 0.5

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("ssl_audio_tpu_torch.eval.finetune.train_classifier", train_classifier)
        evaluate.main(["--device", "cpu", "--dataset", "synthetic", "--model_file_path", path,
                       "--batch_size", "4", "--crop_frames", "32", "--num_workers", "1",
                       "--synthetic_steps_per_epoch", "1", "--projector_hidden_dim", "256"])
    for k, v in enc.state_dict().items():
        assert torch.equal(seen[k], v), k


def test_a_legacy_state_gives_its_online_encoder(tmp_path_factory):
    """As JAX's load_encoder_checkpoint: a DINO state into a Barlow Twins
    state takes the online encoder, not the target's."""
    method, kw, jstate, path = jax_case("dino", tmp_path_factory)
    cfg = default_config(device="cpu", **{k: v for k, v in kw.items() if k != "dino_out_dim"})
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    head = {k: v.clone() for k, v in state.modules["head"].state_dict().items()}
    ckpt_lib.load_encoder_checkpoint(path, state)
    want = W.encoder_state_dict_from_jax(as_np(jstate.params["encoder"]),
                                         as_np(jstate.batch_stats["encoder"]))
    assert_equal_sd(state.modules["encoder"].state_dict(), want)
    assert_equal_sd(state.modules["head"].state_dict(), head)


# --------------------------------------------------------------- the converter

@pytest.mark.parametrize("name,model_type", [("lars_audiontt", "audiontt"),
                                             ("adamw_vit", "vit_tiny")])
def test_to_pth_equals_the_jax_exporter(name, model_type, tmp_path_factory, tmp_path):
    """--to pth from the Orbax directory: JAX's tools/export_torch_ckpt.py's
    file key for key and bit for bit; from the converted .pt, the same
    encoder tensors."""
    from tools import export_torch_ckpt

    method, kw, _, path = jax_case(name, tmp_path_factory)
    flags = ["--model_type", model_type, "--crop_frames", "32"]
    export_torch_ckpt.main(["--ckpt", path, "--out", str(tmp_path / "jax.pth"), *flags])
    convert.main(["--ckpt", path, "--to", "pth", "--out", str(tmp_path / "port.pth"), *flags])
    ref = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    got = torch.load(str(tmp_path / "port.pth"), weights_only=True)
    assert_equal_sd(got, ref)
    pt = str(tmp_path / "model_2.pt")
    convert.main(["--ckpt", path, "--to", "pt", "--out", pt, *argv_of(kw)])
    convert.main(["--ckpt", pt, "--to", "pth", "--out", str(tmp_path / "back.pth")])
    back = torch.load(str(tmp_path / "back.pth"), weights_only=True)
    assert set(back) == set(ref)
    for k, v in back.items():
        if not k.endswith("pos_embed"):           # the ViT's fixed tables: module constants
            assert torch.equal(v, ref[k]), k


def test_a_resumed_step_matches_jax(monkeypatch, tmp_path):
    """A LARS AudioNTT2022 state (momentum, ring and counters perturbed)
    written by JAX, converted --to pt, loaded as Trainer.fit loads it and
    stepped with JAX's draws injected: JAX's next step from the same state,
    loss within TOL relative, the state at compare_states' tolerances; the
    host generator is the JAX run's own."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    from ssl_audio_tpu.train.optim import make_optimizer
    from ssl_audio_tpu.train.state import Modules

    kw = CASES["lars_audiontt"][1]                   # log-mels in: the step without a frontend
    jcfg = jax_config(**kw)
    jstate = jax_initial_state(None, kw)
    mods = Modules(jcfg)
    mods.tx = make_optimizer(jcfg, jstate.params, 2)
    # momentum of the size of one step's LARS update (~1e-3 of a weight)
    jstate = jstate.replace(opt_state=perturbed(jstate.opt_state, 1, scale=1e-4),
                            aug=perturbed(jstate.aug, 2), step=jnp.int32(3))
    path = str(tmp_path / "model_2")
    jckpt.save_checkpoint(path, jstate, 3)
    host = np.random.default_rng(9)
    host.random(3)
    jckpt.save_rng(path, jax.random.key(1), host)
    argv = ["--ckpt", path, "--to", "pt", "--out", str(tmp_path / "model_2.pt"),
            "--dataset", "synthetic", "--batch_size", "4", "--crop_frames", "32",
            "--projector_hidden_dim", "256", "--mixup_n_memory", "8"]
    convert.main(argv)

    cfg = default_config(**kw, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2,
                             device="cpu")
    _, epoch, rng = ckpt_lib.load_checkpoint(str(tmp_path / "model_2.pt"), state)
    _, host2 = ckpt_lib.decode_rng(rng, "cpu")
    assert epoch == 3 and host2.bit_generator.state == host.bit_generator.state
    jstep = jax.jit(jax_make_train_step(mods, raw=True))
    step = make_train_step(cfg)
    lms = np.random.default_rng(0).standard_normal((4, 1, 64, 32)).astype(np.float32)
    key = jax.random.key(100)
    before = {name: {k: v.clone() for k, v in module.state_dict().items()}
              for name, module in state.modules.items()}
    jbefore = {name: dict(sd) for name, sd in W.train_state_dicts_from_jax(
        as_np(jstate.params), as_np(jstate.batch_stats)).items()}
    jstate, jmetrics, _ = jstep(jstate, jnp.asarray(lms), key, np.float32(0.0),
                                jax_init_monitor())
    metrics, _ = step(state, torch.from_numpy(lms), draws=port_draws(key, cfg),
                      monitor=init_monitor("cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=TOL)
    compare_states(state, jstate, before, jbefore)


def test_the_legacy_trainer_resumes_from_a_converted_file(tmp_path_factory, tmp_path,
                                                          monkeypatch):
    """main_pretrain --method byola --resume_path: a converted JAX state
    starts at its epoch with its state (the loop's first step moves the
    converted parameters)."""
    method, kw, jstate, path = jax_case("byola", tmp_path_factory)
    pt = str(tmp_path / "model_2.pt")
    convert.main(["--ckpt", path, "--to", "pt", "--out", pt, "--method", "byola",
                  *argv_of(kw)])
    cfg = default_config(method="byola", device="cpu", epochs=3, num_workers=1,
                         synthetic_steps_per_epoch=1, no_eval=True, **kw)
    monkeypatch.chdir(tmp_path)
    trainer = LegacyTrainer(cfg, "byola")
    trainer.fit(resume_path=pt)
    assert list(trainer.epoch_losses) == [3] and trainer.state.step == 4
    conv = trainer.state.modules["encoder"].features[0].weight
    want = np.transpose(as_np(jstate.params["encoder"]["encoder"]["Conv_0"]["kernel"]),
                        (3, 2, 0, 1))
    assert 0 < float((conv.detach() - torch.from_numpy(want)).abs().max()) < 1e-2


def test_a_directory_is_not_a_resume_file(tmp_path_factory):
    from ssl_audio_tpu_torch import main as tmain

    path = jax_case("lars_audiontt", tmp_path_factory)[3]
    with pytest.raises(ValueError, match="convert_checkpoint"):
        tmain.main(["--device", "cpu", "--dataset", "synthetic", "--resume_path", path])
    assert os.path.isdir(path)
