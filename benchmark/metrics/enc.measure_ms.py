"""enc.measure_ms: the P-frame measure program (enc/fused.py), mean ms a
P frame of the window: Encoder.frame_times[...]["measure"], the
program's own host-clock stage, which ends at a host wait."""

from benchmark.metrics._common import is_p_frame, stage_ms


def read(trace):
    return stage_ms(trace, "measure", is_p_frame)
