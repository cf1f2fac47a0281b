"""The port's own copy of the model configuration.

Same fields and defaults as ``tacotron2_subword_tpu.config.TacotronConfig``
(the reference hparams: 22050 Hz, n_fft 1024, hop 256, 80 mels, n_symbols
313, ...), so a config built for one package describes the same model in the
other.  The port keeps its own copy and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TacotronConfig:
    # -- experiment -------------------------------------------------------
    epochs: int = 1500
    iters_per_checkpoint: int = 1000
    seed: int = 1234
    ignore_layers: Tuple[str, ...] = ("embedding",)

    # -- audio ------------------------------------------------------------
    max_wav_value: float = 32768.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    # -- model ------------------------------------------------------------
    n_symbols: int = 313
    sub_n_symbols: int = 5500
    symbols_embedding_dim: int = 512
    attention: str = "StepwiseMonotonicAttention"
    align_loss: str = ""  # "", "L2", "KL"
    align_loss_max_iters: int = 40000

    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512
    bert_embedding_dim: int = 768

    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.001
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    # The reference prenet runs dropout unconditionally, even in eval.
    prenet_dropout_always_on: bool = True

    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31

    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    # -- optimization -----------------------------------------------------
    use_saved_learning_rate: bool = True
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    grad_clip_thresh: float = 1.0
    batch_size: int = 8  # per device
    mask_padding: bool = True

    # -- auxiliary spectrogram losses --------------------------------------
    # Soft-DTW (normalized by (N + M) * n_mel_channels) and SSIM terms;
    # weight 0 disables each.
    softdtw_loss_weight: float = 0.0
    softdtw_gamma: float = 1.0
    softdtw_bandwidth: float = 0.0      # Sakoe-Chiba band; 0 = no pruning
    softdtw_impl: str = "auto"
    ssim_loss_weight: float = 0.0

    # -- compute ----------------------------------------------------------
    # Compute dtype for matmuls/activations; parameters stay float32.
    # parity_mode computes in float32 (the tests' setting).
    compute_dtype: str = "bfloat16"
    parity_mode: bool = False
    # Weight-only quantization of the decode-loop LSTM weights ("" or
    # "int8"), applied after the cast to the compute dtype.
    decode_quant: str = ""
    decoder_scan_unroll: int = 1
    custom_decoder_vjp: bool = True

    def replace(self, **kw: Any) -> "TacotronConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_freqs(self) -> int:
        return self.filter_length // 2 + 1


def create_config(hparams_string: Optional[str] = None) -> TacotronConfig:
    """The default config with an hparams string in the reference's
    ``"[k:v-k:v]"`` syntax applied (unknown keys are ignored, booleans
    parse the words true/yes/on/1)."""
    cfg = TacotronConfig()
    kw: dict = {}
    if hparams_string:
        body = hparams_string.strip()
        if body.startswith("["):
            body = body[1:]
        for item in body.rstrip("]-").split("-"):
            if ":" not in item:
                continue
            k, v = item.split(":", 1)
            if not hasattr(cfg, k):
                continue
            kind = type(getattr(cfg, k))
            if kind is bool:
                kw[k] = v.strip().lower() in ("1", "true", "yes", "on")
            elif kind is str:
                kw[k] = v
            else:
                kw[k] = kind(v)
    return cfg.replace(**kw)
