"""Linear-probe entry point of the port (the root linear.py of the JAX
package).

    python -m ssl_audio_tpu_torch.linear --model_type audiontt \\
        --model_file_path results/fsd50k/<run>/model_100.pt --model_name myrun

Loads the encoder of a checkpoint written by `ssl_audio_tpu_torch.main`
(`model_{epoch}.pt`, or a params-only / reference-layout `.pth`, through
utils.checkpoint.load_encoder_checkpoint; an empty path probes the seeded
initial weights, as the reference does), extracts embeddings of FSD50K
under `data/` with 711-frame crops, fits the MLP probe, and writes the score
and the 5-per-class low-shot score to
`logs/linear_eval/{dataset}/{model_name}/log.csv`.  Same config flags as
main, plus --model_file_path, --model_name and --model_epoch; it runs on the
card unless `--device cpu` is given.  Orbax checkpoints are not ported yet.
"""
from __future__ import annotations

import torch

from ssl_audio_tpu_torch.config import (
    Config,
    build_argparser,
    parse_config,
    require_supported,
    setup_model_defaults,
)
from ssl_audio_tpu_torch.eval.linear import (
    eval_linear,
    get_fsd50k_eval_loaders,
    make_embedding_forward,
)
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib
from ssl_audio_tpu_torch.utils.logging_utils import make_csv_logger


def load_model(cfg, model_file_path: str):
    """The encoder of cfg on cfg.device, with the checkpoint's weights (or
    the weights drawn from cfg.seed when model_file_path is empty)."""
    state = init_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if model_file_path:
        if not model_file_path.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{model_file_path}: only the port's .pt checkpoints and .pth state dicts "
                "load here (Orbax checkpoints are not ported yet)")
        ckpt_lib.load_encoder_checkpoint(model_file_path, state)
    return state.modules["encoder"]


def main(argv=None) -> dict:
    parser = build_argparser()
    parser.add_argument("--model_file_path", type=str, default="")
    parser.add_argument("--model_name", type=str, default="")
    parser.add_argument("--model_epoch", type=int, default=100)
    args, fields = parse_config(parser, argv)
    cfg = setup_model_defaults(Config(**fields))
    require_supported(cfg)          # before anything is written

    logger = make_csv_logger(f"logs/linear_eval/{cfg.dataset}/{args.model_name}/")
    loaders = get_fsd50k_eval_loaders(cfg)
    encoder = load_model(cfg, args.model_file_path)
    print(f"probing {cfg.model_type} on {cfg.dataset}, device "
          f"{next(encoder.parameters()).device}, encoder compute "
          f"{'bfloat16' if cfg.use_fp16_eval else 'float32'}")
    scores = eval_linear(make_embedding_forward(cfg, encoder), *loaders,
                         device=next(encoder.parameters()).device)
    score_all = scores.get("score_all")
    score_5 = scores.get("score_5", (float("nan"), float("nan")))
    logger.info("epoch,{},linear_score,{},linear_score_5_mean,{},linear_score_5_std,{}".format(
        args.model_epoch, score_all, score_5[0], score_5[1]))
    print(f"linear_score={score_all} low_shot_5={score_5}")
    return scores


if __name__ == "__main__":
    main()
