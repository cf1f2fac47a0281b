"""The vocoder frames kept (max(n, 8) a row) over the frames vocoded, the
padding included, from the program's ``vocoder.frames_live`` and
``vocoder.frames_run`` counters, in the traced run's window.

``attribution.vocoder_live_share`` reads it from ``obs["program"]``, the
program's own record, which a system adapter without a ``_trace`` file
does not have."""

from t2s_bench import attribution as A

LAYER, UNIT, BETTER, SOURCE, _ = A.METRICS["vocoder_live_share.synth"]
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    return A.vocoder_live_share(prog) if prog else None
