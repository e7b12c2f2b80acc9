"""enc.I_idle_ms: the card's idle ms under the program's I-frame span
enc.frame.I (thor_tpu_torch/utils/tracing.span, over the frame's set-up,
upload, search, scan, emit, filters and write), per I frame of the
traced clip."""

from benchmark.metrics._spans import I_FRAMES, idle_ms_per_frame


def read(trace):
    return idle_ms_per_frame(trace, "enc.frame.I", I_FRAMES)
