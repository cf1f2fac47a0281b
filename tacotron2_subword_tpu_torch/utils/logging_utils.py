"""Alignment and spectrogram images (the plotting half of
``tacotron2_subword_tpu/utils/logging_utils.py``, itself the reference's
plotting_utils.py:14-44).

matplotlib is imported inside the functions, with its object-oriented Agg
canvas (no global backend switch), so importing this module needs no
matplotlib.  The TensorBoard logger is not ported yet (ROADMAP Queue 1,
item 9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
