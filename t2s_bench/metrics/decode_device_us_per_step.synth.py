"""The device's time on the rows that the program launched inside its
``decode.loop`` spans (the union of their intervals) per decoder step, in
the profiled batch; rows go to spans by their launch records.

``attribution.decode_device_us_per_step`` reads it from ``obs["program"]``, the
program's own record, which a system adapter without a ``_trace`` file
does not have."""

from t2s_bench import attribution as A

LAYER, UNIT, BETTER, SOURCE, _ = A.METRICS["decode_device_us_per_step.synth"]
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    return A.decode_device_us_per_step(prog) if prog else None
