"""Per-layer metric readers: one file each, metrics/<metric name>.py,
with read(trace) -> the metric's value, or None where the traced run
holds nothing for it to read (the harness then leaves the metric out).
The trace is a benchmark.trace.Trace."""
