"""Peak device memory allocated over the traced run's window
(``torch.cuda.max_memory_allocated``, reset at the window's start)."""

LAYER = "device"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "audio_s_per_s"


def read(obs):
    return obs["peak_bytes"] / 2 ** 30 if obs["peak_bytes"] else None
