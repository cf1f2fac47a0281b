"""The device's idle share of the profiled stretch (one batch, from the
serving entry's call to its wavs on the host): 1 - busy / wall, busy being
the union of the device's kernel, copy and set intervals."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["wall_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
