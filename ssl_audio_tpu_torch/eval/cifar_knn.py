"""The per-epoch CIFAR-10 kNN monitor (port of ssl_audio_tpu/eval/cifar_knn.py;
reference main.py:479-483 and utils.py:192-235): the encoder's embeddings of
the train images as the bank, a weighted-cosine kNN (k = 200, T = 0.5,
eval/knn.py) scored on the test images."""
from __future__ import annotations

import torch

from ssl_audio_tpu_torch.augment.cifar import cifar_eval_batch
from ssl_audio_tpu_torch.data.cifar10 import Cifar10
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.eval.knn import eval_knn
from ssl_audio_tpu_torch.train.state import encoder_forward


def make_cifar_knn_eval_fn(cfg, data_dir: str = "data", wandb_run=None):
    """eval_fn(state, epoch) -> {"knn_top1", "knn_top5"} (percent) for the
    state's encoder, in eval mode on its device (in bf16 with --use_fp16, as
    JAX's apply_encoder).  The datasets are read here, so a missing tree
    raises FileNotFoundError before training starts."""
    memory = Cifar10(data_dir, train=True)
    test = Cifar10(data_dir, train=False)
    mem_loader = DataLoader(memory, cfg.batch_size, shuffle=False, drop_last=False,
                            num_workers=cfg.num_workers)
    test_loader = DataLoader(test, cfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=cfg.num_workers)

    def eval_fn(state, epoch):
        encoder = state.modules["encoder"]
        device = next(encoder.parameters()).device
        was_training = encoder.training
        encoder.eval()
        try:
            with torch.no_grad():
                run = encoder_forward(cfg, encoder)
                top1, top5 = eval_knn(
                    lambda x: run(cifar_eval_batch(x), mean_pool=cfg.use_mean_pool),
                    iter(mem_loader), iter(test_loader), 10, device=device)
        finally:
            encoder.train(was_training)
        print(f"[epoch {epoch}] cifar10 kNN top1={top1:.2f}% top5={top5:.2f}%")
        if wandb_run is not None:
            wandb_run.log({"knn_test_acc_1": top1, "knn_test_acc_5": top5})
        return {"knn_top1": top1, "knn_top5": top5}

    return eval_fn
