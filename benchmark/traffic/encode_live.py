"""A live encoder, closed loop: one client encoding seeded clips one
after another, each clip a sequence of its own that opens with an I frame.

Each clip is a new thor_tpu_torch Encoder over the configuration's
encoder settings (every top-level key of the configuration's file that
names an EncoderParams field), calling Encoder.encode_sequence on the
clip's frames and writing its stream to a file; the reconstruction it
returns is kept for the comparison. The clips come from a fixed bank
(benchmark/clips.py, bank clip k drawn from k): the run's seed sets
which of them the window encodes and in which order, so every seed gives
the same kind of work, and each clip's rate and quality can be held to
an anchor of its own.

Parameters (the cell file's "params"):
  nominal_fps: the rate that sets the window's work: it encodes
    round(seconds x nominal_fps / frames a clip) whole clips, so it lasts
    about --seconds today and shorter as the program gets faster (a
    clip has the configuration's "frames");
  bank: the clips of the bank; the window takes them in the seed's order
    (again from the start where it needs more);
  warm_frames: frames of the warm clip (a clip of its own, the same in
    every run) encoded at set-up, enough to capture every program the
    window's frames replay;
  check_workers: processes the comparison runs in;
  rd: the anchors and limits of the rate and quality each clip is held
    to: "bytes" and "psnr_db" (the anchors, one for each bank clip),
    "bytes_excess_pct" and "psnr_drop_db" (the limits).

Set-up makes the window's clips on the device and encodes the warm clip.
The window is a fixed number of whole clips; encode_fps is every frame of
its clips over the time from its start to the end of its last clip.
Captures the window still makes are counted in the result's "captures".
The traced run encodes the window's first clip once more, whole, under
the profiler, so that its readings have the window's mix of frames.

The comparison, for every clip the window (and the traced run) encoded:
  - mismatched_samples: the plain reference decodes each frame of the
    written stream over the reference window the encoder's own
    reconstruction gives, and the frame must equal the reconstruction the
    encoder returned for it (reference/decode.check_frame). Frame by
    frame, from the I frame on, that is the whole stream decoded by the
    reference and compared;
  - header_mismatches: the stream's sequence header against the
    configuration's settings, and each frame's type, QP and reference
    slots against the configuration's "sequence" (the published
    configuration's frame structure);
  - bytes_excess_pct and psnr_drop_db: the clip's stream size over its
    bank clip's anchor, and its PSNR (every Y, U and V sample of the
    returned reconstruction against the source clip) under its anchor;
    the worst clip counts. Together they hold the encoder's decisions to the rate
    and quality the configuration gives.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

from ..clips import bank_clip, make_clip, sub_seed
from ..harness import Check
from ..trace import reduce, traced

# the sequence header's fields and the configuration's keys that set them
HEADER_KEYS = (("width", "width"), ("height", "height"),
               ("pb_split", "enable_pb_split"),
               ("tb_split_enable", "enable_tb_split"),
               ("max_num_ref", "max_num_ref"), ("interp_ref", "interp_ref"),
               ("max_delta_qp", "max_delta_qp"),
               ("deblocking", "deblocking"), ("clpf", "clpf"),
               ("use_block_contexts", "use_block_contexts"),
               ("bipred", "enable_bipred"))


def encoder_fields(config) -> dict:
    """The configuration's keys that are EncoderParams fields."""
    from thor_tpu_torch.enc.encoder import EncoderParams
    names = {f.name for f in dataclasses.fields(EncoderParams)}
    return {k: v for k, v in config.items() if k in names}


class Traffic:
    def __init__(self, root, config, params, seed, device):
        self.config = config
        self.fields = encoder_fields(config)
        self.width, self.height = self.fields["width"], self.fields["height"]
        self.clip_frames = int(config["frames"])
        self.sequence = config["sequence"]
        self.nominal_fps = float(params["nominal_fps"])
        self.bank = int(params["bank"])
        self.warm_frames = int(params["warm_frames"])
        self.workers = int(params.get("check_workers", 1))
        self.rd = params.get("rd")
        self.seed = int(seed) % 2 ** 63
        self.device = device
        self.done = []  # (stream path, reconstruction, source, bank clip)
        self.frame_times = []   # Encoder.frame_times of the window's clips
        self.captures = {}
        self.attempted = self.failed = 0
        self.window_s = None
        self.rd_readings = []

    def setup(self, seconds):
        import torch
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.tmp = Path(tempfile.mkdtemp(prefix="bench-enc-"))
        order = np.random.default_rng([self.seed, 2]).permutation(self.bank)
        self.order = [int(order[k % self.bank])
                      for k in range(self.window_clips(seconds))]
        made = {}
        for k in self.order:
            if k not in made:
                made[k] = bank_clip(k, self.width, self.height,
                                    self.clip_frames, self.device)
        self.clips = [made[k] for k in self.order]
        warm = make_clip(sub_seed(0, "warm"), self.width, self.height,
                         self.warm_frames, self.device)
        self._encode(warm, self.tmp / "warm.bit")
        self.captures["setup"] = _captures()

    def _encode(self, frames, path, spans=False):
        """Encode one clip into `path`: (reconstruction, frame_times).
        With spans (the traced clip), each half of each frame is a span
        of the benchmark's own (_spanned)."""
        from thor_tpu_torch.enc.encoder import Encoder, EncoderParams
        cls = _spanned(Encoder) if spans else Encoder
        enc = cls(EncoderParams.in_code(num_frames=len(frames),
                                        **self.fields),
                  device=self.device)
        recon = enc.encode_sequence(frames, str(path))
        return recon, enc.frame_times

    def window_clips(self, seconds) -> int:
        """Clips the window encodes: about `seconds` of work at the cell's
        nominal rate, a fixed amount of work."""
        return max(1, round(seconds * self.nominal_fps / self.clip_frames))

    def window(self, seconds):
        c0 = _captures()
        t0 = time.perf_counter()
        for k, clip in enumerate(self.clips):
            path = self.tmp / f"clip{k}.bit"
            recon, ft = self._encode(clip, path)
            self.done.append((path, recon, clip, self.order[k]))
            self.frame_times.extend(ft)
        elapsed = time.perf_counter() - t0
        self.captures["window"] = _captures() - c0
        frames = len(self.clips) * self.clip_frames
        self.attempted = frames
        self.window_s = elapsed
        return {"encode_fps": frames / elapsed}

    def traced(self):
        from ..reference.decode import syntax_counts
        clip = self.clips[0]
        path = self.tmp / "traced.bit"
        with traced(self.device.type == "cuda") as h:
            recon, _ = self._encode(clip, path, spans=True)
        self.done.append((path, recon, clip, self.order[0]))
        intra = Counter()
        for f in syntax_counts(path.read_bytes()):
            intra.update(f["intra"])
        return reduce(h.events, len(clip),
                      {"frame_times": self.frame_times, "intra": intra})

    def release(self):
        import torch
        self.clips = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        from ..reference.decode import check_frame, frame_tasks
        tasks, gaps, headers = [], 0, 0
        self.rd_readings = []
        for path, recon, source, k in self.done:
            data = path.read_bytes()
            ts = frame_tasks(data, recon)
            n = len(source)
            gaps += abs(len(ts) - n) + abs(len(recon) - n)
            tasks.extend(ts)
            headers += self.header_mismatches(data)
            self.rd_readings.append({"clip": k, "bytes": len(data),
                                     "psnr_db": clip_psnr(recon, source)})
        if self.workers > 1 and len(tasks) > 1:
            import multiprocessing as mp
            with mp.get_context("spawn").Pool(self.workers) as pool:
                res = pool.map(check_frame, tasks, chunksize=1)
        else:
            res = [check_frame(t) for t in tasks]
        mismatched = sum(r[0] for r in res)
        self.failed = sum(r[0] > 0 for r in res)
        checks = [Check("mismatched_samples", mismatched, 0),
                  Check("header_mismatches", headers, 0),
                  Check("frame_count_gap", gaps, 0),
                  Check("frames_compared", len(res), 1, at_least=True)]
        if self.rd is not None:
            checks += rd_checks(self.rd_readings, self.rd)
        return checks

    def header_mismatches(self, data) -> int:
        """Sequence-header fields that differ from the configuration's
        settings, and frames whose type, QP or reference slots differ from
        its "sequence" (or that it does not have)."""
        from ..reference.decode import stream_headers
        seq, frames = stream_headers(data)
        bad = sum(getattr(seq, h) != self.config[k] for h, k in HEADER_KEYS)
        want = self.sequence
        bad += sum(k >= len(want) or f != want[k]
                   for k, f in enumerate(frames))
        return bad

    def notes(self):
        return {"captures": self.captures, "clips": len(self.done),
                "window_s": self.window_s, "rd": self.rd_readings}

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def clip_psnr(recon, source) -> float:
    """PSNR in dB of a clip's reconstruction against its source, over
    every Y, U and V sample of every frame together."""
    sse = n = 0
    for got, src in zip(recon, source):
        for a, b in zip(got, src):
            d = a.astype(np.int64) - b.astype(np.int64)
            sse += int(np.dot(d.ravel(), d.ravel()))
            n += d.size
    if len(recon) != len(source) or n == 0:
        return 0.0
    return float("inf") if sse == 0 \
        else float(10 * np.log10(255.0 ** 2 * n / sse))


def rd_checks(readings, rd) -> list:
    """The worst clip's rate over its anchor (%) and PSNR under it (dB),
    each against its limit."""
    excess = max((100.0 * (r["bytes"] / rd["bytes"][r["clip"]] - 1)
                  for r in readings), default=float("inf"))
    drop = max((rd["psnr_db"][r["clip"]] - r["psnr_db"] for r in readings),
               default=float("inf"))
    return [Check("bytes_excess_pct", round(excess, 4),
                  rd["bytes_excess_pct"]),
            Check("psnr_drop_db", round(drop, 4), rd["psnr_drop_db"])]


def _spanned(encoder_cls):
    """The program's Encoder with a span of the benchmark's own around
    each call into a frame's two halves: "bench.enc.<I|P|B>.begin" (the
    search, or a P/B frame's measure program) and "...finish" (the
    decision walk, the second chance, the final program and the emit)."""
    from torch.profiler import record_function

    class Spanned(encoder_cls):
        def encode_frame_begin(self, w):
            with record_function(f"bench.enc.{_kind(self)}.begin"):
                return super().encode_frame_begin(w)

        def encode_frame_finish(self, w, ctx=None):
            with record_function(f"bench.enc.{_kind(self)}.finish"):
                return super().encode_frame_finish(w, ctx)
    return Spanned


def _kind(enc):
    return {0: "I", 1: "P", 2: "B"}.get(int(enc.frame_type), "?")


def _captures():
    try:
        from thor_tpu_torch.ops.graphs import STATS
    except ImportError:
        return 0
    return int(STATS.get("captures", 0))
