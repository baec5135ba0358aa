"""Data-parallel training steps of the port on two gloo ranks on the CPU
(tests/torch_dist_worker.py), against the JAX package's step on the global
batch with world_scale = 2 (make_train_step / make_byol_train_step, jitted):
AudioNTT2022 with the fused block 1 and mixup, two Barlow Twins steps;
vit_tiny with token drop and --masked_recon, two steps; one BYOL step of
AudioNTT2022; and vit_tiny --fused_attention, two steps against one
process of the port on the global batch.  The legacy families and
CIFAR-10 ride on the same two ranks: two DINO steps of AudioNTT2022 (its
dropout keep mask JAX's), one DINO step of vit_tiny with two local crops,
two BYOL-A steps, against JAX's make_dino_train_step /
make_byola_train_step on the global batch; two CIFAR-10 steps of vit_tiny
at 8 x 8 patches (N = 17) against JAX's step with world_scale = 2; and
DINO vit_tiny --fused_attention with two local crops, two steps against
one process of the port.  Each rank takes 4 of the 8 rows.  The ranks
start on the checks that need no JAX side; the JAX side of the legacy
cases is made in a spawned process meanwhile (jax_side_elsewhere), that
of the others in the test process, and each is handed to the ranks as it
comes (torch_dist_worker.post_more).

Draws and views as in tests/test_torch_byol.py: the JAX step's keys give
the crop starts and augmentation parameters of the global batch
(each rank keeps its rows), dropout is the identity on both sides, a ViT's
token-mask noise is handed to both; the port's own views are made (the
mixup bank advances) and held against JAX's within VIEWS_ATOL, then the
step runs on JAX's.  The ViT with --fused_attention is held against the
port's own single process: the JAX kernel in interpret mode costs ~48 s a
step on a CPU, and the bf16 operands of the plain versions part from JAX's
einsum steps at the bf16 level (tests/test_torch_vit_train_step.py).

The legacy steps are held as tests/test_torch_dino.py holds one process
(compare: TOL for the loss, both stacks' parameters and running
statistics and the centre, Adam's moments to MOMENT_TOL, each parameter's
change to DELTA_TOL), the CIFAR-10 steps by their losses, parameters,
AdamW's first moments and each parameter's change likewise.

Tolerances: TOL (1e-4) for the losses, parameters, running statistics and
the mixup bank; LARS's momentum per tensor in relative L2 to FLIP_TOL and
the step each parameter took to that plus PARAM_ROUNDING (the port's and
JAX's ReLU and pool decisions part in the last bits, FLIP_TOL says where);
against one process of the port on the same draws and views after the
first step, ONE_PROCESS_TOL.  The two ranks hold one replica: bit for
bit."""
import contextlib
import functools
import pickle

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.config import default_config as jax_config
from ssl_audio_tpu.models import vit as jvit
from ssl_audio_tpu.train.state import init_train_state as jax_init_train_state
from ssl_audio_tpu.train.steps import _split_rngs
from ssl_audio_tpu.train.steps import make_byol_train_step as jax_make_byol_train_step
from ssl_audio_tpu.train.steps import make_train_step as jax_make_train_step
from ssl_audio_tpu_torch.config import default_config
from ssl_audio_tpu_torch.models import vit
from ssl_audio_tpu_torch.train import legacy_steps
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import StepDraws, crop_start_bound, pass_sizes
from ssl_audio_tpu_torch.utils.weights import train_state_dicts_from_jax
from tests import torch_dist_worker as worker
from tests.test_torch_augment import jax_pair_draws
from tests.test_torch_byol import (
    CONV_KW,
    PARAM_ROUNDING,
    TOL,
    VIEWS_ATOL,
    VIT_KW,
    VIT_ZERO_GRAD,
    VIT_ZERO_GRAD_ATOL,
    ZERO_GRAD,
    ZERO_GRAD_ATOL,
    JaxViews,
    as_np,
    close,
    lars_momentum,
    one_intra_op_thread,  # noqa: F401  (autouse fixture)
    rel_l2,
)
from tests.test_torch_byola import BYOLA_KW
from tests.test_torch_cifar import KW as CIFAR_KW
from tests.test_torch_cifar import TOKENS as CIFAR_TOKENS
from tests.test_torch_cifar import jax_cifar_draws
from tests.test_torch_dino import KW as DINO_KW
from tests.test_torch_dino import MOMENT_TOL, NITER, VIEWS_RTOL
from tests.test_torch_dino import VIT_KW as DINO_VIT_KW
from tests.test_torch_dino import compare as compare_legacy
from tests.test_torch_dino import hold_change, jax_keep_masks, lms, make_pair, port_views
from tests.test_torch_multi_dispatch import assert_tree_equal
from tests.test_torch_train_step import MOMENTUM_TOL
from tests.test_torch_vit import JaxDraws
from tests.test_torch_vit_train_step import adam_first_moments

W = worker.WORLD
B, L = 8, 8000             # the global batch; 4 rows a rank
SMALL_VIT = {"tiny": (64, 2, 4)}
TOKENS = 8                 # vit_tiny over (64, 32) at 16 x 16 patches
CASES = {
    # AudioNTT2022, fused block 1, mixup on (CONV_KW), two Barlow Twins steps
    "audiontt_mixup": dict(kw={**CONV_KW, "batch_size": B, "predictor": False,
                               "mixup_n_memory": 16},
                           steps=[(0.0, None), (0.0, None)]),
    # vit_tiny (einsum attention on both sides), a step with token drop
    "vit_token_drop_recon": dict(kw={**VIT_KW, "batch_size": B, "mixup_n_memory": 16,
                                     "stop_gradient": False, "predictor": False,
                                     "mask": True, "mask_ratio": 0.5, "masked_recon": True},
                                 steps=[(0.5, 4)]),
    # one BYOL step, --stop_gradient --predictor
    "byol_audiontt": dict(kw={**CONV_KW, "batch_size": B, "mixup_n_memory": 16,
                              "stop_gradient": True}, steps=[(0.0, None)], byol=True),
    # the legacy families (main_pretrain --method dino|byola): log-mels in;
    # AudioNTT2022 with JAX's dropout keep mask, the BYOL-A heads' BatchNorm
    "dino_audiontt": dict(kind="legacy", method="dino", kw={**DINO_KW, "batch_size": B},
                          steps=2),
    "dino_vit_local_crops": dict(kind="legacy", method="dino",
                                 kw={**DINO_VIT_KW, "batch_size": B}, steps=1),
    "byola_audiontt": dict(kind="legacy", method="byola", kw={**BYOLA_KW, "batch_size": B},
                           steps=2),
    # CIFAR-10: vit_tiny at 8 x 8 patches, key-bias masking at 0.5, AdamW
    "cifar_vit": dict(kind="cifar", kw={**CIFAR_KW, "batch_size": B}, steps=2),
}
LEGACY_SCALARS = [(0.04, 0.9), (0.05, 0.95)]    # DINO's (teacher temp, momentum) by step
# CIFAR-10's encoder.norm.bias: the projector's BatchNorm removes any shift
# of the latents, so its gradient is float noise (tests/test_torch_cifar.py)
CIFAR_NOISE = ("encoder.norm.bias",)
# After the first step the ranks' parameters differ from one process's in
# the last bits (the batch sums and the correlation are summed in another
# order: 7e-6 in relative L2 per tensor, measured), and at the second step
# that flips a ReLU or pool decision of AudioNTT2022's blocks 1-2 (the flip
# tests/test_torch_train_step.py describes): block 1's and 2's BatchNorm
# shifts and fc.0's bias then read up to 1.1e-3 against one process on the
# same views, every other tensor ~1e-5; the bound of that file
FLIP_TOL = MOMENTUM_TOL
# and so does one process at B = 8 against JAX in a BYOL step: fc.3's and
# fc.0's biases read 1.2e-3 and 6.4e-4 (measured) where tests/test_torch_
# byol.py's B = 4 reads under MOMENT_TOL; the steps are held to FLIP_TOL
# against JAX, and to ONE_PROCESS_TOL against one process of the port on
# the same views after the first step (measured up to 1.0e-5 there)
ONE_PROCESS_TOL = 1e-4
# The fused attention's plain versions take bf16 operands: a rank's rows
# reach them through products over 4 rows instead of 8, which differ in the
# last fp32 bits, and bf16 rounding turns that into ~1e-2 of a small bias's
# step (tools/grad_sensitivity.py measures the same on the card).  After the
# first fused step the parameters as one vector read 9.4e-6 against one
# process and the worst tensor (a LayerNorm bias) 1.03e-2, measured
FUSED_TENSOR_TOL = 3e-2
FUSED_KW = {**VIT_KW, "batch_size": B, "mixup_n_memory": 16, "stop_gradient": False,
            "predictor": False, "fused_attention": True, "mask": True, "mask_ratio": 0.5,
            "masked_recon": True}
FUSED_STEPS = [(0.5, None), (0.5, 4)]
# DINO vit_tiny with two local crops through the fused attention's plain
# versions (N = 5 global, N = 2 local), two steps from one generator
DINO_FUSED_KW = {**DINO_VIT_KW, "batch_size": B, "fused_attention": True}


def kind(case: str) -> str:
    return CASES[case].get("kind", "bt")


def check_name(case: str) -> str:
    """The name of the worker's check that runs a case."""
    legacy = case == "dino_vit_fused" or (case in CASES and kind(case) == "legacy")
    return f"{'legacy_steps' if legacy else 'steps'}#{case}"


def global_draws(key, cfg, byol=False, vit=False) -> StepDraws:
    """The JAX step's draws for `key` over the global batch, as the port's
    StepDraws: dropout keep masks that scale back to exactly 1 (AudioNTT),
    none for a ViT (its noise is set by the caller)."""
    ks = _split_rngs(key)
    starts = np.asarray(jax.random.randint(ks["frontend"], (B,), 0, crop_start_bound(cfg, L)))
    views = jax_pair_draws(ks["aug"], cfg, (B, 1, cfg.n_mels, cfg.crop_frames))
    dropout = None if vit else [torch.full((B, t // 4, 2048), 0.7)
                                for _, t in pass_sizes(cfg, byol=byol)]
    return StepDraws(starts=torch.from_numpy(starts).to(torch.int32), views=views,
                     dropout=dropout)


def port_state(cfg, byol, sd=None):
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=byol,
                             device="cpu")
    if sd is not None:
        state.load_state_dict(sd)
    return state


def jax_modules(jstate, byol, spec):
    out = train_state_dicts_from_jax(as_np(jstate.params), as_np(jstate.batch_stats),
                                     vit_spec=spec)
    if byol:
        out["target"] = train_state_dicts_from_jax(as_np(jstate.target_params),
                                                   as_np(jstate.target_batch_stats),
                                                   vit_spec=spec)
    return out


def stacks(state):
    """(stack, name) -> the port's module, online and (BYOL) target."""
    out = {("online", n): state.modules[n] for n in ("encoder", "head", "predictor")}
    if "target" in state.modules:
        out.update({("target", n): state.modules["target"][n]
                    for n in ("encoder", "head", "predictor")})
    return out


def compare(state, jstate, before, jbefore, byol, spec, moment_tol):
    """Every parameter and running statistic, LARS's momentum and the step
    each trained parameter took (tests/test_torch_byol.py compare, both
    variants)."""
    want = jax_modules(jstate, byol, spec)
    jprev = jax_modules(jbefore, byol, spec)
    for (stack, name), module in stacks(state).items():
        ref = want[name] if stack == "online" else want["target"][name]
        for k, v in module.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                close(v, ref[k], f"{stack} {name}.{k}")
    moments = train_state_dicts_from_jax(as_np(lars_momentum(jstate.opt_state, jstate.params)),
                                         as_np(jstate.batch_stats), vit_spec=spec)
    zero, zero_atol = (VIT_ZERO_GRAD, VIT_ZERO_GRAD_ATOL) if spec else (ZERO_GRAD,
                                                                        ZERO_GRAD_ATOL)
    for name in ("encoder", "head", "predictor"):
        module = state.modules[name]
        for k, p in module.named_parameters():
            if not p.requires_grad:                 # the frozen patch projection
                continue
            got, ref = state.optimizer.state[p]["mu"], moments[name][k]
            if not ref.any():
                assert not got.any(), f"{name}.{k}"
                continue
            if k in zero:
                assert float((got - ref).abs().max()) < zero_atol, f"{name}.{k}"
                continue
            assert rel_l2(got, ref) <= moment_tol, f"momentum of {name}.{k}"
            took = p.detach().double() - before[name][k].double()
            jtook = want[name][k].double() - jprev[name][k].double()
            assert rel_l2(took, jtook) <= moment_tol + PARAM_ROUNDING, f"step of {name}.{k}"


@pytest.fixture(autouse=True)
def small_vits(monkeypatch):
    """The port's "tiny" ViT at width 64, depth 2, 4 heads, as the ranks'."""
    monkeypatch.setattr(vit, "_SIZES", dict(SMALL_VIT))


@contextlib.contextmanager
def jax_side_patched():
    """flax Dropout as the identity, both packages' "tiny" ViT at width 64,
    depth 2, 4 heads (tests/test_torch_vit_train_step.py small_vits)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        mp.setattr(jvit, "_SIZES", dict(SMALL_VIT))
        mp.setattr(vit, "_SIZES", dict(SMALL_VIT))
        yield mp


def jax_case(mp, case):
    """The JAX steps of a case on the global batch -> (the port's initial
    state_dict, the worker's steps, the JAX states before and after each
    step and its metrics)."""
    spec = CASES[case]
    kw, byol = spec["kw"], spec.get("byol", False)
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2, byol=byol)
    factory = jax_make_byol_train_step if byol else jax_make_train_step
    views = JaxViews(mods, jcfg, mp, factory=functools.partial(factory, world_scale=float(W)))
    state = port_state(cfg, byol)
    is_vit = "vit" in cfg.model_type
    sds = jax_modules(jstate, byol, state.modules["encoder"].spec if is_vit else None)
    for (stack, name), module in stacks(state).items():
        module.load_state_dict(sds[name] if stack == "online" else sds["target"][name])
    rng = np.random.default_rng(0)
    steps, jstates, jmetrics = [], [jstate], []
    for i, (ratio, len_keep) in enumerate(spec["steps"]):
        wav = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
        key = jax.random.key(100 + i)
        draws = global_draws(key, cfg, byol=byol, vit=is_vit)
        if is_vit:
            noise = rng.random((B, TOKENS)).astype(np.float32)
            mp.setattr(jvit, "jax", JaxDraws(noise=[noise]))
            draws.noise = [torch.from_numpy(noise), torch.rand(B, TOKENS)]
        jstate, metrics = views.step(jstate, wav, key, ratio, len_keep=len_keep)
        steps.append(dict(batch=wav, draws=draws, views=views.views, mask_ratio=ratio,
                          len_keep=len_keep))
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in metrics.items()})
    return state.state_dict(), steps, jstates, jmetrics


def jax_legacy_case(mp, case):
    """A legacy case's JAX steps on the global batch (tests/test_torch_dino.py
    two_dino_steps) -> (the port's initial state_dict, the worker's steps,
    the JAX states before and after each step, the losses)."""
    spec = CASES[case]
    method = spec["method"]
    _, mods, jstate, jax_step, cfg, state = make_pair(spec["kw"], method, mp)
    shape = (B, 1, cfg.n_mels, cfg.crop_frames)
    steps, jstates, losses = [], [jstate], []
    for i in range(spec["steps"]):
        key, batch = jax.random.key(10 + i), lms(20 + i, shape)
        keep = jax_keep_masks(mods, jstate, key, batch) if cfg.model_type == "audiontt" else []
        scalars = LEGACY_SCALARS[i] if method == "dino" else ()
        jstate, jm = jax_step.step(jstate, batch, key, *(scalars or (0.0,)))
        draws = StepDraws(None, port_views(key, cfg, shape),
                          [torch.from_numpy(keep[0].copy())] if keep else None)
        steps.append(dict(batch=batch, draws=draws, views=jax_step.views, scalars=scalars))
        jstates.append(jstate)
        losses.append({"loss": float(jm["loss"])})
    return state.state_dict(), steps, jstates, losses


def jax_cifar_case(mp, case):
    """The CIFAR-10 case's JAX steps (world_scale 2) on global batches of
    seeded images, its draws replayed from its keys (jax_cifar_draws), one
    token-mask noise for both sides and both steps (the jitted step takes
    it in when traced) -> as jax_case."""
    spec = CASES[case]
    kw = spec["kw"]
    jcfg, cfg = jax_config(**kw), default_config(**kw, device="cpu")
    mods, jstate = jax_init_train_state(jcfg, jax.random.key(0), niter_per_ep=2)
    state = port_state(cfg, False)
    sds = jax_modules(jstate, False, state.modules["encoder"].spec)
    for (_, name), module in stacks(state).items():
        module.load_state_dict(sds[name])
    raw = jax_make_train_step(mods, world_scale=float(W), raw=True)

    def step_and_views(jstate, batch, key):
        seen = []
        make_views = mods.make_views
        mods.make_views = lambda *a: seen.append(make_views(*a)) or seen[0]
        try:
            jstate, metrics = raw(jstate, batch, key, np.float32(0.5))
        finally:
            mods.make_views = make_views
        return jstate, metrics, seen[0][0]

    jitted = jax.jit(step_and_views)
    rng = np.random.default_rng(3)
    noise = rng.random((B, CIFAR_TOKENS)).astype(np.float32)
    mp.setattr(jvit, "jax", JaxDraws(noise=[noise]))
    steps, jstates, jmetrics = [], [jstate], []
    for i in range(spec["steps"]):
        imgs = rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
        key = jax.random.key(200 + i)
        jstate, metrics, views = jitted(jstate, jnp.asarray(imgs), key)
        draws = StepDraws(None, jax_cifar_draws(jax.random.split(key, 5)[0], B),
                          noise=[torch.from_numpy(noise), torch.rand(B, CIFAR_TOKENS)])
        steps.append(dict(batch=imgs, draws=draws, views=[np.array(v) for v in views],
                          mask_ratio=0.5))
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in metrics.items()})
    return state.state_dict(), steps, jstates, jmetrics


ELSEWHERE = [c for c in CASES if kind(c) == "legacy"]   # their JAX side in a process of its own


def jax_side_elsewhere(conn):
    """A spawned process's work: the JAX side of the ELSEWHERE cases, with
    flax's Dropout as it is (AudioNTT2022's one keep mask a step is read off
    JAX for the ranks), sent down `conn` pickled (in band: no shared memory)
    as {case: (state_dict, steps, [the JAX state before the first step,
    after the last] on the host, metrics)}, or ("error", traceback)."""
    try:
        assert jax.default_backend() == "cpu"
        torch.set_num_threads(1)
        out = {}
        for case in ELSEWHERE:
            sd, steps, jstates, jmetrics = unpatched(jax_legacy_case, case)
            out[case] = (sd, steps, jax.device_get([jstates[0], jstates[-1]]), jmetrics)
        conn.send_bytes(pickle.dumps(out))
    except BaseException:
        import traceback

        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        conn.close()


def unpatched(jax_side_of, case):
    """jax_side_of(mp, case) with flax's Dropout as it is, both packages'
    "tiny" ViT as in jax_side_patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "_SIZES", dict(SMALL_VIT))
        mp.setattr(vit, "_SIZES", dict(SMALL_VIT))
        return jax_side_of(mp, case)


def as_check(case, sd, steps):
    """The worker's check of a case from its JAX side."""
    spec = CASES[case]
    if kind(case) == "legacy":
        return dict(kw=spec["kw"], method=spec["method"], state_dict=sd, steps=steps)
    return dict(kw=spec["kw"], state_dict=sd, steps=steps, byol=spec.get("byol", False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the JAX side of every case, both ranks' results, one process's
    results): every case and the fused cases on two ranks, the Barlow Twins
    and fused ones also in this process on the global batch with the same
    draws and views.  The JAX side of the ELSEWHERE cases is made in a
    spawned process meanwhile."""
    import multiprocessing

    parent, child = multiprocessing.get_context("spawn").Pipe(duplex=False)
    helper = multiprocessing.get_context("spawn").Process(target=jax_side_elsewhere,
                                                          args=(child,), daemon=True)
    helper.start()
    child.close()
    rng = np.random.default_rng(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vit, "_SIZES", dict(SMALL_VIT))
        fused_state = port_state(default_config(**FUSED_KW, device="cpu"), False)
        dino_fused = legacy_steps.init_legacy_state(
            default_config(method="dino", **DINO_FUSED_KW, device="cpu"),
            torch.Generator().manual_seed(0), "dino", niter_per_ep=NITER, device="cpu")
    # the checks that need no JAX side: the ranks start on them at once
    checks = {}
    checks["steps#fused"] = dict(
        kw=FUSED_KW, state_dict=fused_state.state_dict(),
        steps=[dict(batch=(0.3 * rng.standard_normal((B, L))).astype(np.float32), gen_seed=5,
                    mask_ratio=r, len_keep=lk) for r, lk in FUSED_STEPS])
    checks["legacy_steps#dino_vit_fused"] = dict(
        kw=DINO_FUSED_KW, method="dino", state_dict=dino_fused.state_dict(),
        steps=[dict(batch=lms(30 + i, (B, 1, 64, 32)), gen_seed=5, scalars=LEGACY_SCALARS[i])
               for i in range(2)])
    first = list(checks.items())
    out = str(tmp_path_factory.mktemp("dist_train"))
    jax_side, one = {}, {}

    def post(cases, last=False):
        """Hands the ranks the checks of these cases from their JAX side."""
        more = {check_name(c): as_check(c, *jax_side[c][:2]) for c in cases}
        worker.post_more(out, list(more.items()), last=last)
        checks.update(more)

    def elsewhere():
        """The helper's JAX side, handed to the ranks as the last checks."""
        got = pickle.loads(parent.recv_bytes())
        if isinstance(got, tuple):
            raise RuntimeError("the JAX side of " + ", ".join(ELSEWHERE) + " failed:\n"
                               + got[1])
        jax_side.update(got)
        post(ELSEWHERE, last=True)

    def meanwhile():
        """While the ranks start and run the first checks: the Barlow Twins
        and CIFAR-10 cases' JAX side here, handed to the ranks as further
        checks; then the one-process checks here, the helper's cases handed
        over as soon as they come (the JAX-held legacy and CIFAR-10 cases
        need no one-process check)."""
        with jax_side_patched() as mp:
            jax_side.update({case: jax_case(mp, case) for case in CASES if kind(case) == "bt"})
        post([c for c in CASES if kind(c) == "bt"])
        jax_side["cifar_vit"] = unpatched(jax_cifar_case, "cifar_vit")
        post(["cifar_vit"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vit, "_SIZES", dict(SMALL_VIT))
            for case in ONE_PROCESS:
                if not set(ELSEWHERE) <= set(jax_side) and parent.poll():
                    elsewhere()
                kw = checks[check_name(case)]
                one[case] = (worker.check_legacy_steps(0, 1, **kw) if "method" in kw
                             else worker.check_steps(0, 1, world_scale=float(W), **kw))
        if not set(ELSEWHERE) <= set(jax_side):
            elsewhere()

    try:
        ranks = worker.spawn({"checks": first, "vit_sizes": SMALL_VIT, "more": True}, out,
                             meanwhile=meanwhile)
    finally:
        parent.close()
        helper.join(timeout=60)
        if helper.is_alive():
            helper.kill()
    return jax_side, ranks, one


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jax_on_the_global_batch(runs, case):
    """Per step: the losses, every parameter, running statistic and the
    mixup bank, LARS's momentum and the step each parameter took, against
    JAX's step with world_scale = 2 on the global batch; the port's own
    views within VIEWS_ATOL of JAX's."""
    jax_side, ranks, _ = runs
    sd0, steps, jstates, jmetrics = jax_side[case]
    res = [r[check_name(case)] for r in ranks]
    for i in range(len(jmetrics)):              # one replica, bit for bit
        assert res[0]["steps"][i]["metrics"] == res[1]["steps"][i]["metrics"]
        assert_tree_equal(res[0]["steps"][i]["state"], res[1]["steps"][i]["state"])
    if kind(case) == "legacy":
        return legacy_matches_jax(case, res, jstates, jmetrics)
    if kind(case) == "cifar":
        return cifar_matches_jax(case, res, sd0, jstates, jmetrics)
    byol = CASES[case].get("byol", False)
    cfg = default_config(**CASES[case]["kw"], device="cpu")
    before = port_state(cfg, byol, sd0)
    spec = before.modules["encoder"].spec if "vit" in cfg.model_type else None
    for i, jm in enumerate(jmetrics):
        got = res[0]["steps"][i]
        for k, v in jm.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=TOL, atol=1e-6,
                                       err_msg=f"{k} of step {i}")
        worker_state = port_state(cfg, byol, got["state"])
        before_sd = {n: {k: v.detach().clone() for k, v in before.modules[n].state_dict().items()}
                     for n in ("encoder", "head", "predictor")}
        compare(worker_state, jstates[i + 1], before_sd, jstates[i], byol, spec, FLIP_TOL)
        np.testing.assert_allclose(worker_state.aug.mixup.bank.numpy(),
                                   np.asarray(jstates[i + 1].aug.mixup.bank), atol=TOL,
                                   err_msg=f"mixup bank after step {i}")
        before = worker_state
    assert max(res[0]["view_gaps"] + res[1]["view_gaps"]) <= VIEWS_ATOL


def legacy_matches_jax(case, res, jstates, jmetrics):
    """The ranks' DINO / BYOL-A steps against JAX's on the global batch:
    each step's loss, then (tests/test_torch_dino.py compare) both stacks'
    parameters, running statistics, the centre, Adam's moments and each
    parameter's change over the steps; the port's views within VIEWS_RTOL
    of JAX's."""
    spec = CASES[case]
    cfg = default_config(method=spec["method"], **spec["kw"], device="cpu")
    for i, jm in enumerate(jmetrics):
        np.testing.assert_allclose(res[0]["steps"][i]["metrics"]["loss"], jm["loss"],
                                   rtol=TOL, atol=1e-6, err_msg=f"loss of step {i}")
    state = legacy_steps.init_legacy_state(cfg, torch.Generator().manual_seed(0),
                                           spec["method"], niter_per_ep=NITER, device="cpu")
    state.load_state_dict(res[0]["steps"][-1]["state"])
    compare_legacy(state, jstates[-1], spec["method"], jstates[0])
    assert state.step == spec["steps"]
    gaps = res[0]["view_gaps"] + res[1]["view_gaps"]
    assert len(gaps) == 2 * spec["steps"] and max(gaps) < VIEWS_RTOL


def cifar_matches_jax(case, res, sd0, jstates, jmetrics):
    """The ranks' CIFAR-10 steps against JAX's with world_scale 2 on the
    global batch: each step's losses; after the last, every parameter to
    TOL, AdamW's first moments per tensor to MOMENT_TOL and each trained
    parameter's change from the start to DELTA_TOL (AdamW's ~lr steps lie
    below TOL); the port's views within VIEWS_ATOL of JAX's."""
    cfg = default_config(**CASES[case]["kw"], device="cpu")
    for i, jm in enumerate(jmetrics):
        for k, v in jm.items():
            np.testing.assert_allclose(res[0]["steps"][i]["metrics"][k], v, rtol=TOL,
                                       atol=1e-6, err_msg=f"{k} of step {i}")
    state = port_state(cfg, False, res[0]["steps"][-1]["state"])
    spec = state.modules["encoder"].spec
    want, start = jax_modules(jstates[-1], False, spec), jax_modules(jstates[0], False, spec)
    mu = train_state_dicts_from_jax(adam_first_moments(jstates[-1].opt_state,
                                                       jstates[-1].params),
                                    as_np(jstates[-1].batch_stats), vit_spec=spec)
    n = 0
    for (_, name), module in stacks(state).items():
        for k, v in module.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                close(v, want[name][k], f"{name}.{k}")
        for k, p in module.named_parameters():
            if not p.requires_grad:                 # the frozen patch projection
                continue
            got, ref = state.optimizer.state[p]["exp_avg"], mu[name][k]
            if f"{name}.{k}" in CIFAR_NOISE:
                assert float((got - ref).abs().max()) <= TOL, f"{name}.{k}"
                continue
            assert rel_l2(got, ref) <= MOMENT_TOL, f"first moment of {name}.{k}"
            n += hold_change(p, want[name][k], start[name][k], f"change of {name}.{k}")
    assert n > 20
    gaps = res[0]["view_gaps"] + res[1]["view_gaps"]
    assert len(gaps) == 2 * len(jmetrics) and max(gaps) <= VIEWS_ATOL


ONE_PROCESS = [c for c in CASES if kind(c) == "bt"] + ["fused", "dino_vit_fused"]


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_two_ranks_are_one_process_on_the_global_batch(runs, case):
    """The same steps of one process on the global batch (world_scale 2,
    the same draws and views): the losses to TOL at every step; after the
    first step every parameter, running statistic and optimizer moment to
    ONE_PROCESS_TOL in relative L2 (conv biases before a BatchNorm, whose
    gradient is float noise, aside).  The two ranks hold one replica, bit
    for bit, at every step.  "fused": vit_tiny --fused_attention with
    --masked_recon, key-bias masking then token drop, the kernels' plain
    versions on each rank's rows, its draws from one generator;
    "dino_vit_fused": DINO vit_tiny --fused_attention with two local crops
    likewise (its centre among the state's tensors)."""
    _, ranks, one = runs
    res = [r[check_name(case)] for r in ranks]
    ref = one[case]["steps"]
    for i, want in enumerate(ref):
        got = [r["steps"][i] for r in res]
        assert got[0]["metrics"] == got[1]["metrics"], f"step {i}: the ranks' losses"
        assert_tree_equal(got[0]["state"], got[1]["state"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=TOL, atol=1e-6,
                                       err_msg=f"{k} of step {i}")
    first, want = res[0]["steps"][0]["state"], ref[0]["state"]
    per_tensor = FUSED_TENSOR_TOL if "fused" in case else ONE_PROCESS_TOL
    names = [k for k, v in want["model"].items()
             if v.is_floating_point() and not k.endswith(ZERO_GRAD + VIT_ZERO_GRAD)]
    for k in names:
        assert torch.equal(first["model"][k], want["model"][k]) or \
            rel_l2(first["model"][k], want["model"][k]) <= per_tensor, k
    assert rel_l2(torch.cat([first["model"][k].reshape(-1) for k in names]),
                  torch.cat([want["model"][k].reshape(-1) for k in names])) <= ONE_PROCESS_TOL
    for pid, st in want["optimizer"]["state"].items():
        for name, m in st.items():
            if isinstance(m, torch.Tensor) and m.is_floating_point() and m.any():
                got = first["optimizer"]["state"][pid][name]
                assert rel_l2(got, m) <= per_tensor or \
                    float((got - m).abs().max()) < ZERO_GRAD_ATOL, f"optimizer {pid} {name}"

