"""A gop x tile mesh of CUDA streams and cards, and the frame program
split across it.

Counterpart of thor_tpu/parallel/mesh.py. There the mesh is a grid of
devices, and the XLA SPMD partitioner splits one batched frame program
over it: frames of a dependency level across 'gop', frame rows across
'tile', with the halo exchanges and the reference-plane all-gather
inserted by XLA. PyTorch has no partitioner, so the port does that work
itself:

- A `Mesh` is a gop x tile grid of *slots*. A slot is a device and, on a
  card, a `torch.cuda.Stream` of its own. With more slots than cards the
  slots share the cards round-robin, each on its own stream (`--mesh 4x2`
  on one card: 8 streams). The port never falls back to the CPU; only
  `devices=["cpu"]` gives CPU slots, which run one after another.
- 'gop': frame j of a level goes to gop row j % gop. Each frame is queued
  as its own program on its slot's stream: PyTorch has no static shapes,
  so thor_tpu's padding of a level to one common batch program
  (`_unify_level`, `_pad0`, the pad to a multiple of gop) has no
  counterpart.
- 'tile': `sharded_reconstruct` splits a frame into row bands on
  superblock-row edges (dec/reconstruct.band_rows). Each tile slot runs
  the residual and block MC (kernel 2) of its band; the bands are
  gathered on the row's tile-0 slot, which runs the intra scan (kernel 1)
  over the whole frame, as the partitioner runs a kernel it cannot split;
  each band is then deblocked and CLPF-filtered on its slot from a slice
  of the unfiltered planes with one superblock row of halo above and
  below (dec/reconstruct.filter_rows), and only the band's rows are kept;
  the tile-0 slot gathers them and edge-pads the reference planes, which
  every slot that reads them then takes (the reference-plane all-gather).
  With tile 1 a frame is exactly dec/reconstruct.reconstruct_frame.

Tensors cross slots under these rules, named where they apply:
  (a) a reader waits on a `torch.cuda.Event` recorded after the
      producer's work, and every tensor one stream makes and another
      reads gets `Tensor.record_stream(reader)`, so the caching allocator
      does not hand its memory to the producer's next allocation while the
      reader's kernels are still queued;
  (b) the kernels are ctypes calls that launch on the calling thread's
      current device and its current stream, so every slot's work runs
      under `Slot.active()` (`torch.cuda.device` and `torch.cuda.stream`);
  (c) kernels 1, 3 and 6 are multi-SM wavefronts that spin on progress
      counters and size their grids to the whole card; their units are
      taken by ticket in coding order, so a resident warp always holds the
      oldest ticket and two of them on one card both move;
  (d) across cards a tensor is copied to the reader's card after the
      producer's event; a kernel never reads another card's memory.

Multi-process: `init_distributed` brings up `torch.distributed` over gloo;
a mesh made afterwards gives each process whole gop rows, each process
builds and reconstructs only its rows' frames, and `fetch_to_host`
all-gathers a level's host planes. Gloo carries host planes only, so two
processes may share one card.
"""

from __future__ import annotations

import contextlib

import torch

from ..dec.decoder import RefFrame
from ..dec.reconstruct import (band_inputs, band_rows, filter_rows,
                               finish_planes, intra_planes, mc_luts,
                               predict_planes, reconstruct_frame,
                               residual_planes, to_device)
from ..device import resolve_device

HALO = 64       # luma rows of halo above and below a band's filter slice


class Slot:
    """One cell of the mesh: a device and, on a card, its own stream."""

    __slots__ = ("device", "stream")

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

    @contextlib.contextmanager
    def active(self):
        """Run the body on this slot: its card and stream current (rule
        (b)); nothing on a CPU slot."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


class Made:
    """Tensors that a slot's stream produces, with an event recorded on
    that stream after them; `on(reader)` hands them to another slot."""

    __slots__ = ("tensors", "slot", "event", "_copies")

    def __init__(self, tensors, slot: Slot):
        self.tensors = tuple(tensors)
        self.slot = slot
        self.event = None
        if slot.stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(slot.stream)
        self._copies = {}

    def on(self, reader: Slot):
        """The tensors as `reader` may read them on its stream."""
        src = self.slot
        if reader is src or src.stream is None:
            return self.tensors
        if reader.device == src.device:
            # rule (a): wait for the producer, and keep the memory from
            # being reused while the reader's work is queued
            reader.stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(reader.stream)
            return self.tensors
        made = self._copies.get(reader.device)
        if made is None:
            # rule (d): the copy runs on the producer's stream, after its
            # work, and the reader's stream waits for it (PyTorch's
            # cross-device copy syncs both current streams)
            with torch.cuda.stream(src.stream), \
                    torch.cuda.stream(reader.stream):
                made = Made((t.to(reader.device, non_blocking=True)
                             for t in self.tensors), reader)
            self._copies[reader.device] = made
        return made.on(reader)


class Mesh:
    """A gop x tile grid of slots. `rows` lists the gop rows this process
    reconstructs (all of them in a single-process run)."""

    def __init__(self, slots, rows=None):
        self.slots = [list(r) for r in slots]
        self.rows = list(range(len(self.slots))) if rows is None \
            else list(rows)
        self._luts = {}

    @property
    def shape(self):
        return len(self.slots), len(self.slots[0])

    @property
    def shared(self) -> bool:
        """Other processes own some gop rows (a multi-process run)."""
        return len(self.rows) < len(self.slots)

    def row_of(self, j: int) -> int:
        """The gop row of frame j of a level."""
        return j % len(self.slots)

    def luts(self, bipred: int, slot: Slot):
        """The MC phase-weight tables on `slot`, made once per device."""
        key = (slot.device, bipred)
        if key not in self._luts:
            with slot.active():
                self._luts[key] = Made(mc_luts(bipred, slot.device), slot)
        return self._luts[key].on(slot)


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None):
    """Bring up torch.distributed over gloo, so a mesh made afterwards
    gives each process its own gop rows. coordinator is 'host:port' of
    process 0 (any free port). Idempotent; without a coordinator and
    before any bring-up it is a single-process run. Returns (rank, world
    size)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if coordinator is None:
            return 0, 1
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _rank_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_decode_mesh(devices=None, gop: int = 0, tile: int = 0) -> Mesh:
    """Mesh over ('gop', 'tile'). devices: every visible card by default
    (raises without one); ["cpu"] gives CPU slots. Default split as
    thor_tpu's: gop 2 when the device count is even and above 1, the rest
    on tile. Slot k (row-major) lies on devices[k % len(devices)]. Under
    torch.distributed, gop row r belongs to process r * world // gop."""
    if devices is None:
        dev = resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if dev.type == "cuda" else [dev]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if not gop:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    if not tile:
        tile = max(1, n // gop)
    slots = [[Slot(devices[(r * tile + t) % n]) for t in range(tile)]
             for r in range(gop)]
    return Mesh(slots, _my_gop_rows(gop))


def _my_gop_rows(gop: int):
    """The gop rows this process owns: whole rows, in contiguous chunks
    of gop / world (a row is never split across processes)."""
    rank, world = _rank_world()
    if gop < world:
        raise ValueError(f"a {gop}-row mesh cannot give each of {world} "
                         "processes a gop row")
    return [r for r in range(gop) if r * world // gop == rank]


def fetch_to_host(mine: dict) -> dict:
    """All-gather a level's host planes across processes: each process
    gives {decode index: (y, u, v) numpy} of its own frames and gets
    every process's. Single-process: `mine` itself."""
    rank, world = _rank_world()
    if world == 1:
        return mine
    import torch.distributed as dist
    got = [None] * world
    dist.all_gather_object(got, mine)
    out = {}
    for d in got:
        out.update(d)
    return out


def _reconstruct_banded(row, cfg, inp, refs, luts_on):
    """One frame across the tile slots of `row` (see the module
    docstring). refs: Made padded planes per reference slot. Returns
    (planes, padded) as Made on the row's tile-0 slot."""
    s0 = row[0]
    H = cfg.H
    bands = [(r0, r1, s) for (r0, r1), s in zip(band_rows(H, len(row)), row)
             if r1 > r0]
    parts = []
    for r0, r1, s in bands:
        with s.active():
            binp = to_device(band_inputs(inp, r0, r1), s.device)
            bcfg = cfg._replace(H=r1 - r0)
            ry, rc = residual_planes(bcfg, binp, s.device)
            rr = [RefFrame(*m.on(s), None) for m in refs]
            y, uv = predict_planes(bcfg, binp, rr, luts_on(s), ry, rc)
            parts.append(Made((y, uv, ry, rc), s))
    fkeys = ("ddp", "beta", "tc", "tcC", "m8y", "m8u", "m8v")
    with s0.active():
        got = [p.on(s0) for p in parts]
        y, uv, ry, rc = (torch.cat([g[k] for g in got], 1 if k % 2 else 0)
                         for k in range(4))
        finp = to_device({k: inp[k] for k in ("it_y", "it_c") + fkeys
                          if k in inp}, s0.device)
        y, uv = intra_planes(finp, y, uv, ry, rc)
        u, v = uv[0], uv[1]
        if not (cfg.deblocking or cfg.clpf):
            planes, padded = finish_planes(y, u, v)
            return Made(planes, s0), Made(padded, s0)
        slices = []
        for r0, r1, s in bands:
            a, b = max(0, r0 - HALO), min(H, r1 + HALO)
            slices.append((a, Made((y[a:b], u[a // 2:b // 2],
                                    v[a // 2:b // 2]), s0)))
    kept = []
    for (r0, r1, s), (a, sl) in zip(bands, slices):
        with s.active():
            sinp = finp if s is s0 else to_device(
                {k: inp[k] for k in fkeys if k in inp}, s.device)
            fy, fu, fv = filter_rows(cfg, sinp, *sl.on(s), r0=a)
            o, oc = r0 - a, (r0 - a) // 2
            kept.append(Made((fy[o:o + r1 - r0],
                              fu[oc:oc + (r1 - r0) // 2],
                              fv[oc:oc + (r1 - r0) // 2]), s))
    with s0.active():
        got = [k.on(s0) for k in kept]
        planes, padded = finish_planes(*(torch.cat([g[i] for g in got])
                                         for i in range(3)))
        return Made(planes, s0), Made(padded, s0)


def sharded_reconstruct(mesh: Mesh, frames, bipred: int = 0):
    """Reconstruct one dependency level over the mesh.

    frames: per frame of the level, (cfg, inputs, refs) with the host
    inputs of dec/inputs.build_frame_inputs and `refs` the Made padded
    planes (y, u, v) of each reference slot, or None for a frame whose gop
    row another process owns. Frame j runs on gop row mesh.row_of(j).
    Returns per frame (planes, padded): Made on the row's tile-0 slot
    ((y, u, v) uint8 and their edge-padded copies), or None where None was
    given. bipred: the sequence header's bipred flag (the MC tables)."""
    def luts_on(s):
        return mesh.luts(bipred, s)

    out = []
    for j, fr in enumerate(frames):
        if fr is None:
            out.append(None)
            continue
        row = mesh.slots[mesh.row_of(j)]
        cfg, inp, refs = fr
        if len(row) == 1:
            s = row[0]
            with s.active():
                planes, padded = reconstruct_frame(
                    cfg, to_device(inp, s.device),
                    [RefFrame(*m.on(s), None) for m in refs], luts_on(s))
                out.append((Made(planes, s), Made(padded, s)))
        else:
            out.append(_reconstruct_banded(row, cfg, inp, refs, luts_on))
    return out
