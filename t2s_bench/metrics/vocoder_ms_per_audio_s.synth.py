"""Host time of the vocoder per second of audio delivered: the spans
around ``models.hifigan.generator_apply`` (each ended by a wait for the
device) over the audio of the traced run's window."""

LAYER = "vocoder"
UNIT = "ms/audio-s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_s_per_s"


def read(obs):
    if not obs["audio_s"] or "vocoder" not in obs["spans"]:
        return None
    return 1e3 * obs["spans"]["vocoder"] / obs["audio_s"]
