"""enc.emit_ms: the emit (native/thor_decide.c thor_emit_frame for P
frames, enc/device_intra.emit_intra_frame for I frames), mean ms a frame
of the window: Encoder.frame_times[...]["emit"]."""

from benchmark.metrics._common import stage_ms


def read(trace):
    return stage_ms(trace, "emit")
