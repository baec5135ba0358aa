"""Checkpoints and deterministic resume of the port (utils/checkpoint.py,
TrainState.state_dict, Trainer.fit, main's --save_base_dir / --resume_path)
on the CPU at small widths.

The generator words are held against the JAX package's encode_rng; a run
that is stopped after its epoch-2 checkpoint and resumed must equal an
uninterrupted run bit for bit (the JAX package's tests/test_loop.py
TestDeterministicResume); a training checkpoint serves through the HEAR
wrappers as it is."""
import os

import jax
import numpy as np
import pytest
import torch

from ssl_audio_tpu.utils import checkpoint as jckpt
from ssl_audio_tpu_torch import main as tmain
from ssl_audio_tpu_torch.augment import augmentations as A
from ssl_audio_tpu_torch.config import config_from_args
from ssl_audio_tpu_torch.hear import conv as hear_conv
from ssl_audio_tpu_torch.hear import vit as hear_vit
from ssl_audio_tpu_torch.train import optim as optim_lib
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.utils import checkpoint as ckpt

# small widths: 4 clips per batch, crop 32, a narrow projector, a bank of 12
# (not a multiple of the batch: a resumed run must find the write position)
SMALL = ["--device", "cpu", "--batch_size", "4", "--crop_frames", "32",
         "--projector_hidden_dim", "64", "--projector_out_dim", "32", "--num_workers", "1",
         "--synthetic_steps_per_epoch", "2", "--mixup_n_memory", "12", "--epoch_save_f", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The module's torch work on one intra-op thread, its module fixtures'
    included (set up before any test's own fixtures): the suite runs six workers
    on the host's cores, where a pool of threads per worker waits on its
    stragglers at every small op (tens of times slower than one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(*extra, epochs=4):
    return config_from_args([*SMALL, "--epochs", str(epochs), *extra])


def assert_tree_equal(a, b, where=""):
    """Every tensor bit for bit and every other leaf equal, in nested dicts
    and lists."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def roundtrip(obj, tmp_path, name="x.pt"):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return torch.load(path, weights_only=True)


# ---------------------------------------------------------------- generators

def used_host_generator(seed=11):
    host = np.random.default_rng(seed)
    host.random(5)
    host.integers(0, 2 ** 16, 3, dtype=np.uint32)    # leaves a cached half-word
    return host


def test_encode_rng_words_equal_jax():
    host = used_host_generator()
    words = ckpt.encode_rng(torch.Generator(), host)["host_pcg64"]
    jwords = jckpt.encode_rng(jax.random.key(7), host)["host_pcg64"]
    assert jwords.dtype == np.uint64 and len(words) == 6
    assert words == [int(w) for w in jwords]
    assert words[4] == 1                                 # has_uint32: the cached half


def test_generators_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(7, generator=gen)
    host = used_host_generator()
    enc = roundtrip(ckpt.encode_rng(gen, host), tmp_path)
    gen2, host2 = ckpt.decode_rng(enc, "cpu")
    # the JAX package decodes the same words to the same host generator
    _, jhost = jckpt.decode_rng({"key_data": jax.random.key_data(jax.random.key(0)),
                                 "host_pcg64": np.asarray(enc["host_pcg64"], np.uint64)})
    assert host2.bit_generator.state == host.bit_generator.state == jhost.bit_generator.state
    np.testing.assert_array_equal(host2.random(4), host.random(4))
    assert torch.equal(torch.rand(5, generator=gen2), torch.rand(5, generator=gen))


# ------------------------------------------------------ optimizers, aug state

def params_and_grads(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(6, 5, generator=g)),
            torch.nn.Parameter(torch.randn(5, generator=g))]


def take_steps(opt, sched, params, n, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        if sched is not None:
            sched.step()


@pytest.mark.parametrize("optimizer", ["LARS", "AdamW"])
def test_optimizer_and_schedule_survive_save_and_load(optimizer, tmp_path):
    """LARS's step count and momentum, AdamW's moments and its LambdaLR: a
    fresh optimizer loaded from the saved one continues exactly as the
    saved one does, warmup + cosine factor included."""
    cfg = small_cfg("--optimizer", optimizer, "--lr", "1e-2", "--lr_schedule", epochs=200)
    runs = []
    for _ in range(2):
        params = params_and_grads()
        opt, sched = optim_lib.make_optimizer(cfg, params, niter_per_ep=2)
        runs.append((params, opt, sched))
    (p1, o1, s1), (p2, o2, s2) = runs
    take_steps(o1, s1, p1, 5, seed=1)
    saved = roundtrip({"opt": o1.state_dict(),
                       "sched": None if s1 is None else s1.state_dict()}, tmp_path)
    with torch.no_grad():
        for a, b in zip(p2, p1):
            a.copy_(b)
    o2.load_state_dict(saved["opt"])
    if optimizer == "LARS":
        assert s1 is None and saved["opt"]["count"] == 5 and o2.count == 5
        assert o2.factor_fn(o2.count) == o1.factor_fn(o1.count) != o1.factor_fn(0)
    else:
        s2.load_state_dict(saved["sched"])
        assert s2.last_epoch == 5 and s2.get_last_lr() == s1.get_last_lr()
    assert_tree_equal(o2.state_dict(), o1.state_dict(), "optimizer")
    take_steps(o1, s1, p1, 3, seed=2)
    take_steps(o2, s2, p2, 3, seed=2)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)


def test_mixup_bank_count_and_pos_survive(tmp_path):
    """A bank that has wrapped: rows, count and the next write position."""
    g = torch.Generator().manual_seed(0)
    state = A.init_mixup_state(6, (1, 4, 5))
    for _ in range(3):
        A.mixup_byola(g, torch.randn(4, 1, 4, 5, generator=g), state)
    assert (state.count, state.pos) == (6, 0)
    A.apply_mixup(torch.randn(4, 1, 4, 5, generator=g), state,
                  torch.zeros(4, 1, 1, 1), torch.zeros(4, dtype=torch.long))
    assert (state.count, state.pos) == (6, 4)
    fresh = A.init_mixup_state(6, (1, 4, 5))
    fresh.load_state_dict(roundtrip(state.state_dict(), tmp_path))
    assert (fresh.count, fresh.pos) == (6, 4) and torch.equal(fresh.bank, state.bank)


# ----------------------------------------------------------- resume, in full

class Stop(Exception):
    """Ends a run partway, as a crash would."""


def run(cfg, ckpt_path=None, resume=None, stop_at=None):
    """Trainer.fit -> the trainer; stop_at: raise when that epoch starts."""
    tr = Trainer(cfg, log=lambda line: None)
    if stop_at is not None:
        epoch_fn = tr.train_one_epoch

        def until(epoch):
            if epoch == stop_at:
                raise Stop
            return epoch_fn(epoch)

        tr.train_one_epoch = until
    try:
        tr.fit(ckpt_path=ckpt_path, resume_path=resume)
    except Stop:
        pass
    return tr


RESUME_CASES = {
    "audiontt_lms_lars_schedule_pre_norm": ["--dataset", "synthetic", "--lr_schedule",
                                            "--pre_norm"],
    "audiontt_wav": ["--dataset", "synthetic_wav"],
    "vit_adamw_mask_schedule": ["--dataset", "synthetic_wav", "--model_type", "vit_tiny",
                                "--optimizer", "AdamW", "--lr", "1e-3", "--lr_schedule",
                                "--mask", "--mask_ratio_schedule", "--fused_attention"],
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resumed_run_is_bit_identical(case, tmp_path):
    """4 epochs in one run == 2 epochs, saved, the run stopped, resumed from
    model_2.pt and run to epoch 4: the per-epoch losses and every tensor of
    the final state (modules, optimizer, schedule, mixup bank) and of the
    generators.  The stopped run has the 4-epoch run's settings, so the LR
    and mask-ratio schedules span 4 epochs in both."""
    cfg = small_cfg(*RESUME_CASES[case])
    full = run(cfg)
    stopped = run(cfg, ckpt_path=str(tmp_path), stop_at=3)
    assert sorted(os.listdir(tmp_path)) == ["model_2.pt"]
    resumed = run(cfg, ckpt_path=str(tmp_path), resume=str(tmp_path / "model_2.pt"))
    assert list(stopped.epoch_losses) == [1, 2] and list(resumed.epoch_losses) == [3, 4]
    assert stopped.epoch_losses == {e: full.epoch_losses[e] for e in (1, 2)}
    assert resumed.epoch_losses == {e: full.epoch_losses[e] for e in (3, 4)}
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict(), "state")
    assert resumed.state.step == 8
    assert torch.equal(resumed.gen.get_state(), full.gen.get_state())
    assert resumed.host_rng.bit_generator.state == full.host_rng.bit_generator.state
    assert sorted(os.listdir(tmp_path)) == ["model_2.pt", "model_4.pt"]


def test_checkpoint_file_loads_weights_only(tmp_path):
    tr = run(small_cfg("--dataset", "synthetic", epochs=1), ckpt_path=str(tmp_path))
    ck = torch.load(tmp_path / "model_1.pt", map_location="cpu", weights_only=True)
    assert set(ck) == {"model", "optimizer", "scheduler", "augment", "step", "epoch", "rng"}
    assert ck["epoch"] == 2 and ck["step"] == 2 and ck["scheduler"] is None
    assert ck["optimizer"]["count"] == 2
    assert ck["augment"]["mixup"]["count"] == 8 and ck["augment"]["running_norm"] is None
    assert all(k.split(".")[0] in ("encoder", "head", "predictor") for k in ck["model"])
    assert_tree_equal(ck["model"], tr.state.modules.state_dict(), "model")


def test_resume_from_another_configuration_raises(tmp_path):
    run(small_cfg("--dataset", "synthetic", epochs=1), ckpt_path=str(tmp_path))
    other = Trainer(small_cfg("--dataset", "synthetic", "--projector_out_dim", "16"),
                    log=lambda line: None)
    with pytest.raises(RuntimeError, match="size mismatch"):
        other.fit(resume_path=str(tmp_path / "model_1.pt"))
    with pytest.raises(FileNotFoundError):
        other.fit(resume_path=str(tmp_path / "model_9.pt"))


# ------------------------------------------------------ serving a checkpoint

def test_hear_conv_serves_a_training_checkpoint(tmp_path):
    """hear.conv.load_model(model_e.pt) holds the trainer's encoder: its
    weights and its embeddings equal a model given the encoder in memory."""
    tr = run(small_cfg("--dataset", "synthetic_wav", "--seed", "3", epochs=1),
             ckpt_path=str(tmp_path))
    served = hear_conv.load_model(str(tmp_path / "model_1.pt"), device="cpu")
    mem = hear_conv.load_model("", device="cpu")
    mem.model.load_state_dict(tr.state.modules["encoder"].state_dict())
    assert_tree_equal(served.model.state_dict(), tr.state.modules["encoder"].state_dict())
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16000))
                             .astype(np.float32) * 0.1)
    emb, ts = hear_conv.get_timestamp_embeddings(audio, served)
    emb_mem, ts_mem = hear_conv.get_timestamp_embeddings(audio, mem)
    assert torch.equal(emb, emb_mem) and torch.equal(ts, ts_mem)
    assert torch.equal(hear_conv.get_scene_embeddings(audio, served),
                       hear_conv.get_scene_embeddings(audio, mem))


def test_hear_vit_serves_a_training_checkpoint(tmp_path):
    """A vit_tiny training checkpoint with the reconstruction decoder (which
    HEAR leaves out) through hear.vit.load_model; units of crop_frames 96."""
    tr = run(small_cfg("--dataset", "synthetic_wav", "--model_type", "vit_tiny",
                       "--crop_frames", "96", "--masked_recon", "--mask", "--mask_ratio",
                       "0.5", "--seed", "4", epochs=1), ckpt_path=str(tmp_path))
    served = hear_vit.load_model(str(tmp_path / "model_1.pt"), "vit_tiny", "16x16",
                                 device="cpu")
    mem = hear_vit.load_model("", "vit_tiny", "16x16", device="cpu")
    enc = {k: v for k, v in tr.state.modules["encoder"].state_dict().items()
           if not k.startswith(("decoder", "mask_token"))}
    mem.model.load_state_dict(enc)
    assert_tree_equal(served.model.state_dict(), enc)
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 24000))
                             .astype(np.float32) * 0.1)
    assert torch.equal(hear_vit.get_scene_embeddings(audio, served),
                       hear_vit.get_scene_embeddings(audio, mem))
    assert torch.equal(hear_vit.get_timestamp_embeddings(audio, served)[0],
                       hear_vit.get_timestamp_embeddings(audio, mem)[0])


def test_load_encoder_checkpoint(tmp_path):
    """A whole train state of the same configuration restores in full; a
    params-only file with another head grafts the encoder; an encoder of
    another width raises ValueError; a missing file FileNotFoundError."""
    cfg = small_cfg("--dataset", "synthetic", "--model_type", "vit_tiny",
                    "--optimizer", "AdamW", "--lr", "1e-3", epochs=1)
    src = run(cfg, ckpt_path=str(tmp_path)).state
    same = init_train_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    ckpt.load_encoder_checkpoint(str(tmp_path / "model_1.pt"), same)
    assert_tree_equal(same.state_dict(), src.state_dict(), "whole state")

    ckpt.save_params_only(str(tmp_path / "params.pt"), src.modules)
    other_head = init_train_state(cfg.replace(projector_out_dim=16),
                                  torch.Generator().manual_seed(9), device="cpu")
    head_before = other_head.modules["head"].state_dict()
    ckpt.load_encoder_checkpoint(str(tmp_path / "params.pt"), other_head)
    assert_tree_equal(other_head.modules["encoder"].state_dict(),
                      src.modules["encoder"].state_dict(), "grafted encoder")
    assert_tree_equal(other_head.modules["head"].state_dict(), head_before, "own head")
    assert other_head.step == 0

    wider = init_train_state(cfg.replace(model_type="vit_small"),
                             torch.Generator().manual_seed(9), device="cpu")
    with pytest.raises(ValueError, match="does not match the configured model"):
        ckpt.load_encoder_checkpoint(str(tmp_path / "model_1.pt"), wider)
    with pytest.raises(FileNotFoundError):
        ckpt.load_encoder_checkpoint(str(tmp_path / "missing.pt"), same)


def test_params_only_round_trip(tmp_path):
    cfg = small_cfg("--dataset", "synthetic", epochs=1)
    a = init_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = init_train_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    ckpt.save_params_only(str(tmp_path / "p.pt"), a.modules)
    ckpt.load_params_only(str(tmp_path / "p.pt"), b.modules)
    assert_tree_equal(b.modules.state_dict(), a.modules.state_dict())


# ------------------------------------------------------------ the eval hook

@pytest.mark.parametrize("no_eval", [False, True])
def test_eval_hook_every_epoch_eval_f_and_at_the_last(no_eval, tmp_path):
    """eval_fn(state, epoch) at epochs 2 and 3 of 3 with --epoch_eval_f 2
    (never with --no_eval), its scores in the JAX CSV line beside the step
    lines."""
    extra = ["--dataset", "synthetic", "--epoch_eval_f", "2"] + (["--no_eval"] if no_eval else [])
    lines, calls = [], []
    tr = Trainer(small_cfg(*extra, epochs=3), log=lines.append, log_dir=str(tmp_path / "log"))

    def eval_fn(state, epoch):
        assert state is tr.state and state.step == 2 * epoch
        calls.append(epoch)
        return {"score": epoch / 10}

    tr.fit(eval_fn=eval_fn)
    assert calls == ([] if no_eval else [2, 3])
    csv = (tmp_path / "log" / "log.csv").read_text().splitlines()
    scores = [line for line in csv if "linear_score" in line]
    want = [] if no_eval else ["epoch,2,step,4,linear_score,{'score': 0.2}",
                               "epoch,3,step,6,linear_score,{'score': 0.3}"]
    assert scores == want and [line for line in lines if "linear_score" in line] == want
    assert [line.split(",")[:4] for line in csv if ",loss," in line] == [
        ["epoch", str(e), "step", str(2 * (e - 1))] for e in (1, 2, 3)]


# ------------------------------------------------------------ the entry point

def test_main_saves_and_resumes(tmp_path, monkeypatch, capsys):
    """main with --save_base_dir: model_e.pt every epoch_save_f epochs and at
    the last one, the CSV log under the working directory; --resume_path
    continues from the next epoch to the same final state."""
    monkeypatch.chdir(tmp_path)
    argv = [*SMALL, "--dataset", "synthetic", "--epoch_save_f", "2",
            "--save_base_dir", "run", "--name", "x"]
    full = tmain.main([*argv, "--epochs", "3"])
    (out_dir,) = [os.path.join(r, d) for r, ds, _ in os.walk("run") for d in ds
                  if d.startswith("audiontt_x")]
    assert sorted(os.listdir(out_dir)) == ["model_2.pt", "model_3.pt"]
    (log_dir,) = [r for r, _, fs in os.walk("logs/training/synthetic") if "log.csv" in fs]
    with open(os.path.join(log_dir, "log.csv")) as f:
        lines = f.read().splitlines()
    assert [line.split(",")[:4] for line in lines] == [
        ["epoch", str(e), "step", str(2 * (e - 1))] for e in (1, 2, 3)]
    # as in JAX, the synthetic log-mels have no eval hook to disable
    assert "Epoch eval disabled" not in capsys.readouterr().out

    resumed = tmain.main([*argv, "--epochs", "3", "--save_base_dir", "again",
                          "--resume_path", os.path.join(out_dir, "model_2.pt")])
    assert "Resumed from" in capsys.readouterr().out
    assert list(resumed.epoch_losses) == [3]
    assert resumed.epoch_losses[3] == full.epoch_losses[3]
    assert_tree_equal(resumed.state.state_dict(), full.state.state_dict())
    with pytest.raises(FileNotFoundError):
        tmain.main([*argv, "--epochs", "3", "--resume_path", "nowhere/model_2.pt"])
