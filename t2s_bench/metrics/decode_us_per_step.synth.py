"""Host time of the decode loop per decoder step: the spans around
``models.tacotron2.decoder_infer`` (each ended by a wait for the device)
over the steps it ran, in the traced run's window."""

LAYER = "decode loop"
UNIT = "us/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_s_per_s"


def read(obs):
    steps = obs["steps"]
    if not steps or "decode_loop" not in obs["spans"]:
        return None
    return 1e6 * obs["spans"]["decode_loop"] / steps
