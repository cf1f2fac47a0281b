"""Kernel K1's share of its roofline in the profiled stretch: the least
time of its launches (``flops.k1_bound_s``: HBM bytes at 3.35 TB/s or
FLOPs at 989 TFLOP/s, the larger, two launches a decode step) over their
device time.  The int8 weights of one step (31.5 MB) fit in the 50 MB L2,
so a share near 100 % points at the byte count before the kernel."""

from t2s_bench import flops

LAYER = "kernel K1"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"


def read(obs):
    tr = obs.get("trace")
    if not tr:
        return None
    name = obs["kernels"].get("k1")
    times = [d for label, rows in tr["segments"] for n, _, d in rows
             if name and name in n]
    if not times:
        return None
    bound = len(times) / 2 * flops.k1_step_bound_s(obs["tacotron"],
                                                   tr["batch"])
    return flops.share_pct(bound, sum(times) / 1e6)
