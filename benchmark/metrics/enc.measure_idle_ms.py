"""enc.measure_idle_ms: the card's idle ms under the program's span
enc.measure (thor_tpu_torch/utils/tracing.span), per P/B frame span
(enc.frame.P, enc.frame.B) of the traced clip."""

from benchmark.metrics._spans import P_FRAMES, idle_ms_per_frame


def read(trace):
    return idle_ms_per_frame(trace, "enc.measure", P_FRAMES)
