"""The profiled batch's idle gaps longer than a queued row's (the host
launched the row that ends them after the device had gone idle) over the
batch's wall time: at most ``idle_share.synth`` of the same batch.

``attribution.host_bound_idle_share`` reads it from ``obs["program"]``, the
program's own record, which a system adapter without a ``_trace`` file
does not have."""

from t2s_bench import attribution as A

LAYER, UNIT, BETTER, SOURCE, _ = A.METRICS["host_bound_idle_share.synth"]
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    return A.host_bound_idle_share(prog) if prog else None
