"""The exported HiFi-GAN vocoders of the port: ONNX and TFLite files.

Counterpart of ``tacotron2_subword_tpu/models/vocoder_runtimes.py`` (the
reference's onnxruntime / tf.lite back-ends, reference inference.py:
208-238, best_checkpoint.py:230-260).  An ``.onnx`` file (written by
``tools.export_hifigan_onnx`` or any exporter within the op set) runs
through ``utils.onnx_lite``'s torch executor on the device the caller
gives.  Unlike the JAX package, the port does not pick up onnxruntime when
it is importable: a CPU session would move the vocoder off the card
without the caller asking.  A ``.tflite`` file runs through
``tf.lite.Interpreter``, a CPU runtime: tensorflow is imported only when
such a file is loaded, and its absence raises RuntimeError.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def load_tflite_vocoder(model_path: str) -> Vocoder:
    """vocode: mel [B, n_mels, T] -> wav [B, T'] through the TFLite
    interpreter on the host, the result on the mel's device (reference
    best_checkpoint.py:230-260)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(
            "tensorflow is not installed in this environment; use the "
            "native HiFi-GAN (models.hifigan) or install tensorflow") from e
    interp = tf.lite.Interpreter(model_path=model_path)

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        x = mel.detach().to("cpu", torch.float32).numpy()
        index = interp.get_input_details()[0]["index"]
        interp.resize_tensor_input(index, x.shape)
        interp.allocate_tensors()
        interp.set_tensor(index, x)
        interp.invoke()
        out = interp.get_tensor(interp.get_output_details()[0]["index"])
        out = np.ascontiguousarray(out, np.float32)
        return torch.from_numpy(out.reshape(out.shape[0], -1)).to(mel.device)

    return vocode
