"""CUDA graphs shared by the programs of both codecs: the decoder's frame
program (dec/fused.py), the interpolated reference of RA / HDB streams
(ops/interp_fused.py: the decoder's and the encoder's), and the device
encoder's P/B programs (enc/fused.py) and I-frame programs
(enc/fused_intra.py).

A program is captured once per signature as a torch.cuda.CUDAGraph and
replayed on the current stream after that. Its warm-up runs on a side
stream first (PyTorch's graph notes: cuBLAS, the kernels' libraries and
the constant tables initialise outside a capture). The entries of both
codecs live in one cache, CACHE, keyed by (device, signature), of at
most 256 entries (thor_tpu's lru_cache bound; the least recently used
goes first); the entries of a device share one graph memory pool: replays
run one at a time on one stream, and a replay's outputs are read or
cloned before the next one. On the CPU there is no graph: a program just
runs. A capture that fails raises.

The sharded decoder and encoder (parallel/stream.py, parallel/encode.py)
stay on the eager stages: their slots dispatch on several streams at
once, and the replays of a device's shared pool run one at a time.

The kernels of COUNTED (kernels 1 and 2 of the decoder, the three
interpolation kernels, and the encoder's kernel 6 and zero-run pass)
count their launches where their wrappers launch them. Under a capture
they launch nothing, so a program keeps the counts its capture added,
takes them back, and adds them at every replay (the warm-up before a capture runs on the card and counts
as it runs). STATS counts the captures (and their host milliseconds,
warm-up included), the replays and the entries evicted.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from .enc_intra import encode_scan
from .interp import me_level, mot_comp, mot_comp_uv
from .intra import intra_scan
from .kernels import rdoq_light
from .mc import mc_frame

MAXSIZE = 256       # _jit_fused's lru_cache bound
COUNTED = (mc_frame, intra_scan, encode_scan, rdoq_light, me_level, mot_comp,
           mot_comp_uv)

STATS = {"captures": 0, "capture_ms": 0.0, "replays": 0, "evictions": 0}


def counted_capture(run):
    """run() with the counted kernels' launch counts restored after it:
    (run's result, the counts it added)."""
    before = [f.launches for f in COUNTED]
    try:
        out = run()
    finally:
        added = [f.launches - b for f, b in zip(COUNTED, before)]
        for f, b in zip(COUNTED, before):
            f.launches = b
    return out, added


class GraphProgram:
    """A program run as one CUDA graph on a card: its graph, the graph's
    outputs (rewritten in place by every replay) and the launch counts
    its capture took back. On the CPU the program just runs."""

    def __init__(self):
        self.graph = self.out = None
        self.launches = [0] * len(COUNTED)

    def capture_program(self, dev, pool, program):
        """Warm program() up on a side stream, then capture it into the
        device's shared graph pool `pool`. A capture that fails raises."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        side = side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            program()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = program()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
            return out

        self.out, self.launches = counted_capture(capture)
        cur.wait_stream(side)
        self.graph = graph
        STATS["captures"] += 1
        STATS["capture_ms"] += (time.perf_counter() - t0) * 1e3

    def replay_graph(self):
        """Replay the graph on the current stream: its outputs."""
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n
        STATS["replays"] += 1
        return self.out

    def run(self, dev, pool, program):
        """program() on the CPU; on a card its graph, captured at the
        first call: the outputs (.out) either way."""
        if dev.type != "cuda":
            self.out = program()
            return self.out
        if self.graph is None:
            self.capture_program(dev, pool, program)
        return self.replay_graph()


class FrameCache:
    """Entries by (device, signature), least recently used evicted past
    `maxsize`. An entry has .graph (None until it captures one). An
    evicted graph may still be queued: the device's current stream is
    drained before it goes (at most once per new signature beyond the
    bound)."""

    def __init__(self, maxsize: int = MAXSIZE):
        self.maxsize = maxsize
        self.entries: OrderedDict = OrderedDict()
        self.pools: dict = {}       # device -> the graph pool's handle

    def pool(self, dev):
        """The graph pool the entries of `dev` share."""
        if dev not in self.pools:
            with torch.cuda.device(dev):
                self.pools[dev] = torch.cuda.graph_pool_handle()
        return self.pools[dev]

    def get(self, key, make):
        """(entry, True if it was made now)."""
        e = self.entries.get(key)
        if e is not None:
            self.entries.move_to_end(key)
            return e, False
        e = make()
        self.entries[key] = e
        if len(self.entries) > self.maxsize:
            while len(self.entries) > self.maxsize:
                (dev, _), old = self.entries.popitem(last=False)
                if old.graph is not None:
                    torch.cuda.current_stream(dev).synchronize()
                STATS["evictions"] += 1
            self.forget_idle_pools()
        return e, True

    def discard(self, key):
        """Drop the entry of `key` (one whose first run failed: its graph
        never ran)."""
        self.entries.pop(key, None)
        self.forget_idle_pools()

    def drop(self, kind=object):
        """Drop every entry that is an instance of `kind` (all by
        default), once the cards that may still run one of their graphs
        have drained."""
        keys = [k for k, e in self.entries.items() if isinstance(e, kind)]
        for dev in {k[0] for k in keys if self.entries[k].graph is not None}:
            torch.cuda.synchronize(dev)
        for k in keys:
            del self.entries[k]
        self.forget_idle_pools()

    def clear(self):
        """Drop every entry."""
        self.drop()

    def _graph_devices(self):
        return {d for (d, _), e in self.entries.items()
                if e.graph is not None}

    def forget_idle_pools(self):
        """A pool lives while a graph captured into it does: the handle of
        a device with no graph left is stale, and the next capture there
        takes a new one."""
        live = self._graph_devices()
        for dev in [d for d in self.pools if d not in live]:
            del self.pools[dev]


CACHE = FrameCache()
_side: dict = {}


def side_stream(dev):
    """The side stream of `dev` that warm-ups and captures run on."""
    if dev not in _side:
        _side[dev] = torch.cuda.Stream(device=dev)
    return _side[dev]


def device(dev) -> torch.device:
    """`dev` with its index (the cache's keys name the card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
