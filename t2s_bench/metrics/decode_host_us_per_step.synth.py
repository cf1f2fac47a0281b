"""The host's own time in the decode loop per decoder step, in the traced
run's window: the program's ``decode.loop`` spans less its ``decode.sync``
reads (the check of "all finished"), over its ``decode.steps`` counter.

``attribution.decode_host_us_per_step`` reads it from ``obs["program"]``, the
program's own record, which a system adapter without a ``_trace`` file
does not have."""

from t2s_bench import attribution as A

LAYER, UNIT, BETTER, SOURCE, _ = A.METRICS["decode_host_us_per_step.synth"]
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    return A.decode_host_us_per_step(prog) if prog else None
