from tacotron2_subword_tpu_torch.eval.metrics import (
    dtw_path,
    estimate_f0,
    mcd_between_wavs,
    mel_cepstrum,
    trim_silence,
)

__all__ = ["dtw_path", "estimate_f0", "mcd_between_wavs", "mel_cepstrum",
           "trim_silence"]
