"""enc.host_waits: the places a frame's host needed a device result
(thor_tpu_torch/utils/tracing.count_wait: the fused programs' fetches,
the stage-wise syncs, the filters' stream wait, the reconstruction's
fetch), mean over the window's frames: Encoder.frame_times[...]["waits"].
"""


def read(trace):
    vals = [ft["waits"] for ft in trace.extra.get("frame_times", [])
            if "waits" in ft]
    return sum(vals) / len(vals) if vals else None
