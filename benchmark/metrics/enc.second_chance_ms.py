"""enc.second_chance_ms: the second chance (enc/device_inter
.collect_missing and its trials program), mean ms a P frame of the
window: Encoder.frame_times[...]["second_chance"]."""

from benchmark.metrics._common import is_p_frame, stage_ms


def read(trace):
    return stage_ms(trace, "second_chance", is_p_frame)
