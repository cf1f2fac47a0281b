"""The exported HiFi-GAN vocoders of the port: ONNX and TFLite files.

Counterpart of ``tacotron2_subword_tpu/models/vocoder_runtimes.py`` (the
reference's onnxruntime / tf.lite back-ends, reference inference.py:
208-238, best_checkpoint.py:230-260).  An ``.onnx`` file (written by
``tools.export_hifigan_onnx`` or any exporter within the op set) runs
through ``utils.onnx_lite``'s torch executor, and a ``.tflite`` file
(written by ``tools.export_hifigan_tflite``, or by the root jax2tf tool)
through ``utils.tflite_lite``'s, each on the device the caller gives, the
mel and the waveform staying there.  Unlike the JAX package, the port
picks up neither onnxruntime nor tensorflow: a host session would move the
vocoder off the card without the caller asking.
"""

from __future__ import annotations

from typing import Callable

import torch

Vocoder = Callable[[torch.Tensor], torch.Tensor]  # mel [B,M,T] -> wav [B,T']


def load_onnx_vocoder(model_path: str, device) -> Vocoder:
    """vocode: mel [B, n_mels, T] -> wav [B, T'] (f32, on ``device``), the
    file's initializers moved to ``device`` once here."""
    from tacotron2_subword_tpu_torch.utils import onnx_lite as OX
    with open(model_path, "rb") as f:
        graph = OX.load_graph(OX.decode_model(f.read()), device)
    name = graph.input_names[0]

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        out = OX.run_model(graph, {name: mel})[0]
        return out.reshape(out.shape[0], -1)

    return vocode


def load_tflite_vocoder(model_path: str, device) -> Vocoder:
    """vocode: mel [B, n_mels, T] -> wav [B, T'] (f32, on ``device``), the
    file's constants moved to ``device`` once here.  The file's input shape
    is fixed: a mel of another shape raises ValueError."""
    from tacotron2_subword_tpu_torch.utils import tflite_lite as TL
    with open(model_path, "rb") as f:
        graph = TL.load_graph(TL.decode_model(f.read()), device)

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        out = TL.run_model(graph, [mel])[0]
        return out.reshape(out.shape[0], -1)

    return vocode
