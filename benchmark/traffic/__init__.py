"""Traffic kinds: one module each, found by the name a cell file gives.

A kind's module defines a class Traffic(root, config, params, seed,
device): root, the checkout; config, the configuration's file; params,
the cell file's "params"; seed, the run's --seed; device, a
torch.device. The harness calls, in order:

  - setup(seconds): everything before a window of `seconds` (the
    program's objects, its kernels' load, the warm-up that captures every
    shape the window uses, the window's inputs);
  - window(seconds) -> {end-to-end metric: value}: the measured window;
  - traced() -> benchmark.trace.Trace: the traced sub-window (--trace 1);
  - release(): free the program's state on the device;
  - check() -> [benchmark.harness.Check]: the comparison with the plain
    reference, after release();
  - notes() -> {key: value}: extra keys for the result line;
  - close(): remove what the run wrote.

and reads .attempted and .failed, the operations the window attempted
and those that failed.
"""
