"""The whole synthesis batch's share of the card's bf16 peak: the model
FLOPs of the frames delivered in the traced run's window (encoders at the
sentences' lengths, decode steps up to each stop, postnet and vocoder per
delivered frame; padding not counted) over the window's wall time times
989 TFLOP/s."""

from t2s_bench import flops

LAYER = "serving entry"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "audio_s_per_s"


def read(obs):
    return flops.share_pct(obs["flops"],
                           obs["window_s"] * flops.PEAK_BF16_FLOPS)
