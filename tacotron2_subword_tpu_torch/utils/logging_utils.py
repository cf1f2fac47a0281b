"""Alignment, spectrogram and gate images, and the TensorBoard logger of
the training CLI (the port's copy of ``tacotron2_subword_tpu/utils/
logging_utils.py``; reference plotting_utils.py:14-61, logger.py).

matplotlib is imported inside the functions, with its object-oriented Agg
canvas (no global backend switch), and tensorboardX inside
``Tacotron2Logger``, so importing this module needs neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _render(data: np.ndarray, xlabel: str, ylabel: str) -> np.ndarray:
    """imshow of ``data`` with a colour bar on a 6x4 in, 100 dpi figure →
    HWC uint8 image."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    fig = Figure(figsize=(6, 4), dpi=100)
    canvas = FigureCanvasAgg(fig)
    ax = fig.subplots()
    im = ax.imshow(data, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    canvas.draw()
    return np.asarray(canvas.buffer_rgba())[:, :, :3].copy()


def plot_alignment(alignment: np.ndarray,
                   info: Optional[str] = None) -> np.ndarray:
    """[T_out, T_text] → HWC image (reference plotting_utils.py:14-29)."""
    xlabel = "Decoder timestep" + (f"\n\n{info}" if info else "")
    return _render(np.asarray(alignment).T, xlabel, "Encoder timestep")


def plot_spectrogram(spectrogram: np.ndarray) -> np.ndarray:
    """[n_mels, T] → HWC image (reference plotting_utils.py:32-44)."""
    return _render(np.asarray(spectrogram), "Frames", "Channels")


def save_image(img: np.ndarray, path: str) -> None:
    """Write an HWC image as PNG."""
    from matplotlib.image import imsave
    imsave(path, img)


def plot_gate_outputs(gate_targets: np.ndarray,
                      gate_outputs: np.ndarray) -> np.ndarray:
    """Gate target (green +) and predicted (red .) per frame on an 8x3 in
    figure -> HWC image (reference plotting_utils.py:47-61)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    fig = Figure(figsize=(8, 3), dpi=100)
    canvas = FigureCanvasAgg(fig)
    ax = fig.subplots()
    x = np.arange(len(gate_targets))
    ax.scatter(x, gate_targets, alpha=0.5, color="green", marker="+", s=1,
               label="target")
    ax.scatter(x, gate_outputs, alpha=0.5, color="red", marker=".", s=1,
               label="predicted")
    ax.set_xlabel("Frames (Green target, Red predicted)")
    ax.set_ylabel("Gate State")
    fig.tight_layout()
    canvas.draw()
    return np.asarray(canvas.buffer_rgba())[:, :, :3].copy()


def _named_leaves(tree, prefix: str = ""):
    """(slash-joined path, leaf) of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Tacotron2Logger:
    """TensorBoard scalars per logged step, and per validation the loss, a
    histogram per parameter leaf and the alignment, mel and gate images
    (reference logger.py)."""

    def __init__(self, logdir: str, max_histograms: Optional[int] = None):
        """``max_histograms``: at most this many parameter histograms per
        validation (None: every leaf, as the reference)."""
        try:
            from tensorboardX import SummaryWriter
            import matplotlib  # noqa: F401  (the validation images)
        except ImportError as e:
            raise ImportError(
                f"-l/--log_directory needs the tensorboardX and matplotlib "
                f"packages ({e}); install them or train without -l") from e
        self.writer = SummaryWriter(logdir)
        self.max_histograms = max_histograms

    def log_training(self, metrics: Dict[str, Any], learning_rate: float,
                     duration: float, iteration: int) -> None:
        scalars = {
            "training.loss": metrics.get("total"),
            "training.mel_loss": metrics.get("mel"),
            "training.gate_loss": metrics.get("gate"),
            "training.align_loss": metrics.get("align"),
            "training.align_bert_loss": metrics.get("align_bert"),
            "grad.norm": metrics.get("grad_norm"),
            "learning.rate": learning_rate,
            "duration": duration,
        }
        for k, v in scalars.items():
            if v is not None:
                self.writer.add_scalar(k, float(v), iteration)

    def log_validation(self, val_loss: float, params, outputs, batch,
                       iteration: int) -> None:
        """``outputs``/``batch``: the last validation batch's, as
        ``eval_step`` returns and takes them (tensors on any device)."""
        self.writer.add_scalar("validation.loss", float(val_loss), iteration)
        leaves = _named_leaves(params)
        cap = self.max_histograms
        if cap is not None and len(leaves) > cap:
            print(f"[logger] histogram cap: logging {cap}/{len(leaves)} "
                  "param leaves", flush=True)
            leaves = leaves[:cap]
        for name, value in leaves:
            self.writer.add_histogram(name, _host(value), iteration)

        idx = np.random.randint(0, outputs["alignments"].shape[0])
        mel = _host(outputs["mel_postnet"][idx])
        self.writer.add_image(
            "alignment", plot_alignment(_host(outputs["alignments"][idx])),
            iteration, dataformats="HWC")
        if "alignments_bert" in outputs:
            self.writer.add_image(
                "alignment_bert",
                plot_alignment(_host(outputs["alignments_bert"][idx])),
                iteration, dataformats="HWC")
        self.writer.add_image("mel_predicted", plot_spectrogram(mel),
                              iteration, dataformats="HWC")
        self.writer.add_image("mel_target",
                              plot_spectrogram(_host(batch["mels"][idx])),
                              iteration, dataformats="HWC")
        gate_o = _host(outputs["gate"][idx])
        self.writer.add_image(
            "gate", plot_gate_outputs(_host(batch["gate_target"][idx]),
                                      1 / (1 + np.exp(-gate_o))),
            iteration, dataformats="HWC")

    def close(self) -> None:
        self.writer.close()
