"""Device records (kernels, copies, sets) of the decode loop per decoder
step, from the profiled stretch: the records between the markers of the
``decoder_infer`` span over the steps it ran."""

LAYER = "decode loop"
UNIT = "launches/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr["steps"]:
        return None
    n = sum(len(rows) for label, rows in tr["segments"]
            if label == "decode_loop")
    return n / tr["steps"] if n else None
