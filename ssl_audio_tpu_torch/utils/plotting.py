"""Loss curves from training CSV logs (port of ssl_audio_tpu/utils/plotting.py;
reference old/utils/plotting.py:12-55, which reads checkpoints; this reads
the 'epoch,{e},step,{s},loss,{l},...' lines that utils/logging_utils.py
make_csv_logger writes).  matplotlib is imported only by plot_losses (the
card's machine has none)."""
from __future__ import annotations

from typing import Dict, List, Tuple


def read_loss_csv(path: str) -> Tuple[List[int], List[float]]:
    steps, losses = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 6 and parts[0] == "epoch" and parts[4] == "loss":
                steps.append(int(parts[3]))
                losses.append(float(parts[5]))
    return steps, losses


def plot_losses(csv_paths: Dict[str, str], out_path: str = "loss_curves.png"):
    """csv_paths: {label: path}.  Writes a PNG; ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is required for plotting") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for label, path in csv_paths.items():
        steps, losses = read_loss_csv(path)
        ax.plot(steps, losses, label=label)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
