"""CUDA graphs shared by the programs of both codecs: the decoder's frame
program (dec/fused.py) and its banded form on the sharded decoder's slots
(parallel/fused.py), the interpolated reference of RA / HDB streams
(ops/interp_fused.py: the decoder's and the encoder's), and the device
encoder's P/B programs (enc/fused.py) and I-frame programs
(enc/fused_intra.py).

A program is captured once per signature as a torch.cuda.CUDAGraph and
replayed after that. Its warm-up runs on a side stream first (PyTorch's
graph notes: cuBLAS, the kernels' libraries and the constant tables
initialise outside a capture). The entries of both codecs live in one
cache, CACHE, keyed by (lane, signature), of at most 256 entries
(thor_tpu's lru_cache bound; the least recently used goes first).

Lanes. A lane is a device and the stream its programs replay on: by
default the device's current stream, so that a sharded slot
(parallel/mesh.Slot.active) selects its own lane, and the single-card
paths, on the default stream, share one. A CPU slot has no stream: its
Slot.active names its lane (tagged). Each lane has its own entries,
its own graph memory pool (the entries of a lane share it: their replays
run one after another on the lane's stream, and a replay's outputs are
read or cloned before the next one), its own side stream for warm-ups
and captures, and its own lock. A caller holds the lane's lock from an
entry's load through its replay to the clone or fetch of its outputs, so
that two threads on one lane (two decoders, or a decoder and an encoder,
on one card) enqueue those steps whole, in stream order; lanes on other
streams run at once, each in its own pool. Captures are serialised
across the process (side streams may be shared once the stream pool
wraps). On the CPU there is no graph: a program just runs, under the
same lanes and locks. A capture that fails raises.

The kernels of COUNTED (kernels 1 and 2 of the decoder, the three
interpolation kernels, and the encoder's kernel 6, zero-run pass and
quarter-pel motion search)
count their launches where their wrappers launch them. Under a capture
they launch nothing, so a program keeps the counts its capture added,
takes them back, and adds them at every replay (the warm-up before a
capture runs on the card and counts as it runs). STATS counts the
captures (and their host milliseconds, warm-up included), the replays and
the entries evicted; each lane counts its own captures, capture
milliseconds and replays.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict

import torch

from .enc_intra import encode_scan
from .interp import me_level, mot_comp, mot_comp_uv
from .intra import intra_scan
from .kernels import rdoq_light
from .mc import mc_frame
from .me_subpel import subpel_search

MAXSIZE = 256       # _jit_fused's lru_cache bound
COUNTED = (mc_frame, intra_scan, encode_scan, rdoq_light, me_level, mot_comp,
           mot_comp_uv, subpel_search)

STATS = {"captures": 0, "capture_ms": 0.0, "replays": 0, "evictions": 0}
_CAPTURE = threading.Lock()     # one warm-up and capture at a time


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


class Lane:
    """A device and the stream its programs replay on (None on the CPU),
    with the lane's lock, its side stream (made at the first capture) and
    its own counts. Its graph pool is CACHE.pool(lane)."""

    __slots__ = ("dev", "stream", "key", "lock", "_side", "graphs",
                 "captures", "capture_ms", "replays")

    def __init__(self, dev: torch.device, stream, key):
        self.dev, self.stream, self.key = dev, stream, key
        self.lock = threading.RLock()
        self._side = None
        self.graphs = weakref.WeakSet()     # the programs captured here
        self.captures, self.capture_ms, self.replays = 0, 0.0, 0

    def side(self):
        """The side stream that warm-ups and captures of this lane run on
        (high priority, so never a slot's stream from PyTorch's pool)."""
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.dev, priority=-1)
        return self._side

    def drain(self):
        """Wait until the lane's stream has run what is queued on it."""
        if self.stream is not None:
            self.stream.synchronize()

    def __repr__(self):
        return f"Lane{self.key}"


_lanes: dict = {}
_tag = threading.local()


@contextlib.contextmanager
def tagged(tag):
    """In the body (on this thread) the CPU's lane is the one named `tag`
    (a card's lane is its current stream)."""
    old = getattr(_tag, "value", None)
    _tag.value = tag
    try:
        yield
    finally:
        _tag.value = old


def lane(dev) -> Lane:
    """The lane of `dev` (made at its first use): the device's current
    stream on a card, the tag of the enclosing `tagged` (None outside
    one) on the CPU."""
    dev = device(dev)
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        key = (str(dev), stream.stream_id)
    else:
        stream, key = None, (str(dev), getattr(_tag, "value", None))
    ln = _lanes.get(key)
    if ln is None:
        ln = _lanes.setdefault(key, Lane(dev, stream, key))
    return ln


def lanes(dev=None):
    """The lanes made so far (of `dev`, or of every device)."""
    dev = None if dev is None else device(dev)
    return [ln for ln in list(_lanes.values())
            if dev is None or ln.dev == dev]


class GraphProgram:
    """A program run as one CUDA graph on a card: its graph, the graph's
    outputs (rewritten in place by every replay) and the launch counts
    its capture took back. On the CPU the program just runs."""

    def __init__(self):
        self.graph = self.out = None
        self.launches = [0] * len(COUNTED)

    def capture_program(self, ln: Lane, program):
        """Warm program() up on the lane's side stream, then capture it
        into the lane's graph pool. A capture that fails raises."""
        t0 = time.perf_counter()
        with _CAPTURE:
            cur = ln.stream
            side = ln.side()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                program()
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=CACHE.pool(ln),
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
        ln.graphs.add(self)
        ms = (time.perf_counter() - t0) * 1e3
        STATS["captures"] += 1
        STATS["capture_ms"] += ms
        ln.captures += 1
        ln.capture_ms += ms

    def replay_graph(self, ln: Lane):
        """Replay the graph on the lane's stream: its outputs."""
        with torch.cuda.stream(ln.stream):
            self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n
        STATS["replays"] += 1
        ln.replays += 1
        return self.out

    def run(self, ln: Lane, program):
        """program() on the CPU; on a card its graph, captured at the
        first call: the outputs (.out) either way."""
        if ln.dev.type != "cuda":
            self.out = program()
            return self.out
        if self.graph is None:
            self.capture_program(ln, program)
        return self.replay_graph(ln)


def _cloned(out):
    """A clone of each tensor of `out` (a tensor, or a tuple of tensors
    and tuples of tensors)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(_cloned(t) for t in out)


def run_cached(ln: Lane, sig, make, load):
    """Under lane ln's lock: the cache's entry of (ln, sig) (make() makes
    a new one), load(entry), then entry.program on ln (on a card its
    graph, captured at the first call) and, on a card, clones of its
    outputs (a tensor or nested tuples of tensors), which later replays
    leave as they are. A new entry whose first run fails leaves the cache
    again."""
    key = (ln, sig)
    with ln.lock:
        e, fresh = CACHE.get(key, make)
        try:
            load(e)
            out = e.run(ln, e.program)
        except BaseException:
            if fresh:
                CACHE.discard(key)
            raise
        return _cloned(out) if ln.dev.type == "cuda" else out


class FrameCache:
    """Entries by (lane, signature), least recently used evicted past
    `maxsize`. An entry has .graph (None until it captures one). An
    evicted graph may still be queued: its lane's stream is drained
    before it goes (at most once per new signature beyond the bound).
    `mutex` guards the dictionaries against threads on other lanes."""

    def __init__(self, maxsize: int = MAXSIZE):
        self.maxsize = maxsize
        self.entries: OrderedDict = OrderedDict()
        self.pools: dict = {}       # lane -> its graph pool's handle
        self.mutex = threading.RLock()

    def pool(self, ln: Lane):
        """The graph pool the programs of lane `ln` share: a new one once
        no graph captured on the lane lives (PyTorch frees a pool with its
        last graph, and its handle must not be used again), whether its
        programs were cache entries or not."""
        with self.mutex:
            if ln not in self.pools or not any(
                    p.graph is not None for p in list(ln.graphs)):
                with torch.cuda.device(ln.dev):
                    self.pools[ln] = torch.cuda.graph_pool_handle()
            return self.pools[ln]

    def get(self, key, make):
        """(entry, True if it was made now)."""
        with self.mutex:
            e = self.entries.get(key)
            if e is not None:
                self.entries.move_to_end(key)
                return e, False
            e = make()
            self.entries[key] = e
            if len(self.entries) > self.maxsize:
                while len(self.entries) > self.maxsize:
                    (ln, _), old = self.entries.popitem(last=False)
                    if old.graph is not None:
                        ln.drain()
                    STATS["evictions"] += 1
            return e, True

    def discard(self, key):
        """Drop the entry of `key` (one whose first run failed: its graph
        never ran)."""
        with self.mutex:
            self.entries.pop(key, None)

    def drop(self, kind=object):
        """Drop every entry that is an instance of `kind` (all by
        default), once the lanes that may still run one of their graphs
        have drained."""
        with self.mutex:
            keys = [k for k, e in self.entries.items()
                    if isinstance(e, kind)]
            for ln in {k[0] for k in keys
                       if self.entries[k].graph is not None}:
                ln.drain()
            for k in keys:
                del self.entries[k]

    def clear(self):
        """Drop every entry."""
        self.drop()

    def of_lane(self, ln: Lane):
        """The entries of lane `ln`."""
        with self.mutex:
            return [e for (k, _), e in self.entries.items() if k is ln]


CACHE = FrameCache()


def device(dev) -> torch.device:
    """`dev` with its index (the lanes name the card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
