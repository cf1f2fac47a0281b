"""The decode's row-steps up to each row's stop over all row-steps run
(B x steps), from the program's ``decode.live_row_steps`` and
``decode.row_steps`` counters, in the traced run's window.

``attribution.decode_live_share`` reads it from ``obs["program"]``, the
program's own record, which a system adapter without a ``_trace`` file
does not have."""

from t2s_bench import attribution as A

LAYER, UNIT, BETTER, SOURCE, _ = A.METRICS["decode_live_share.synth"]
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    return A.decode_live_share(prog) if prog else None
