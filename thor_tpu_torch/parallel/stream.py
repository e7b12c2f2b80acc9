"""Sharded decode of real bitstreams over a gop x tile mesh of CUDA
streams and cards.

Counterpart of thor_tpu/parallel/stream.py. The serial entropy parse
stays on the host (one pass, in decode order, `lookahead` frames ahead of
reconstruction). Reconstruction is scheduled in *dependency levels*: every
parsed frame whose read references (and interpolated-reference sources)
are made joins the current level, and the level runs at once over the
mesh (parallel/mesh.sharded_reconstruct): its frames across the 'gop'
slots, each frame's rows across its row's 'tile' slots. Hierarchical-B
streams (RA / RA16 / HDB) give levels of 2..8 frames; low-delay chains
have levels of one frame and use the tile axis alone.

Where it differs from thor_tpu's:
- a frame's program is queued on its own slot as it is, so nothing pads a
  level to one common batch (see parallel/mesh.py); with fused=True (the
  default) it replays CUDA graphs on the slot's lane (ops/graphs: each
  slot's stream has its own entries, pool and lock): the Decoder's frame
  graph at tile 1 (dec/fused.py), the band, intra and filter programs of
  parallel/fused.py at tile > 1; fused=False queues the stages eagerly;
- the interpolated reference of an RA / HDB frame is synthesized on the
  frame's tile-0 slot (kernels 3-5), not on the host: with fused=True a
  replay of its signature's graph on that slot's lane
  (ops/interp_fused.run_interp), as the Decoder makes it, with
  fused=False by ops/interp stage by stage;
- references stay on the device between levels; only yielded frames are
  copied to the host, into pinned memory (in a multi-process run, a
  level's frames are gathered on every host);
- a C parse that fails to build raises; there is no Python fallback.
On the native parse the dependency analysis reads each block's mode,
reference indices and direction from the C parse's frame; on the Python
parse from the same fields, which dec/syntax_inputs lays out alike.
"""

from __future__ import annotations

import os
import warnings

import torch

from ..bitstream.reader import BitReader, iter_frames
from ..codec.constants import (MAX_REF_FRAMES, MAX_REORDER_BUFFER,
                               MODE_INTRA, PAD_C, PAD_Y)
from ..dec.decoder import PARSERS, RefFrame, _Output, needs_interp
from ..dec.inputs import build_frame_inputs
from ..dec.parse import FrameParser, SequenceHeader
from ..dec.syntax_inputs import syntax_to_native
from ..native import lib, parse_frame, seqhdr_from_python
from ..ops import interp
from ..ops.interp_fused import run_interp
from ..ops.kernels import edge_pad
from .mesh import Made, fetch_to_host, make_decode_mesh, \
    sharded_reconstruct


class _Placeholder:
    """Identity of a reference in the sliding window: its display number
    and the decode index that produces it (None: the zero frames the
    window starts with)."""

    __slots__ = ("frame_num", "producer")

    def __init__(self, frame_num, producer):
        self.frame_num = frame_num
        self.producer = producer


class _Frame:
    """A reconstructed frame: its output on the way to the host, and its
    padded planes as Made on the producing slot (made on first use from
    the host planes when another process reconstructed it)."""

    __slots__ = ("out", "ref", "host")

    def __init__(self, out=None, ref=None, host=None):
        self.out, self.ref, self.host = out, ref, host

    def planes(self):
        if self.host is None:
            self.host = self.out.get()
            self.out = None
        return self.host


class ShardedDecoder:
    """Parse-then-level decoder over a gop x tile mesh: see the module
    docstring. mesh, or (gop, tile, devices) for make_decode_mesh (every
    visible card by default; devices=["cpu"] for CPU slots). parse:
    "native" (the C parse) or "python" (dec/parse.FrameParser).
    lookahead: how many frames the parse runs ahead of reconstruction; it
    must cover a sub-GOP to expose the B levels. level_chunk: the most
    frames of a level reconstructed at once (0: the THOR_LEVEL_CHUNK
    environment variable, else no bound; 1 reconstructs frame by frame).
    fused: CUDA graphs on the slots' lanes (the default; on the CPU the
    same programs without a graph), or the eager stages (False). A
    capture that fails raises."""

    def __init__(self, mesh=None, gop: int = 0, tile: int = 0,
                 devices=None, parse: str = "native",
                 lookahead: int = 32, level_chunk: int = 0,
                 fused: bool = True):
        if parse not in PARSERS:
            raise ValueError(f"parse must be one of {PARSERS}")
        self.mesh = mesh if mesh is not None else make_decode_mesh(
            devices, gop=gop, tile=tile)
        self.parse_mode = parse
        if parse == "native":
            lib()               # a C parse that fails to build raises here
        self.lookahead = lookahead
        self.level_chunk = level_chunk or int(
            os.environ.get("THOR_LEVEL_CHUNK", "0") or 0)
        self.fused = fused
        self.mc_clamped = 0
        self.last_level_sizes = []

    def _parse_frame(self, seq, cs, payload, pos, nums):
        if self.parse_mode == "native":
            return parse_frame(payload, pos, cs, nums)
        br = BitReader(payload)
        br.pos = pos
        return syntax_to_native(FrameParser(seq, br, nums).parse(), seq)

    def decode_stream(self, path: str):
        """Decode a full stream; returns frames in display order (list
        wrapper over the streaming generator)."""
        return list(self.iter_frames(path))

    def iter_frames(self, path: str):
        """Streaming decode: yields (y, u, v) uint8 numpy planes in display
        order. Reconstructed frames are released once outside every
        future frame's 33-deep reference window and yielded, so memory
        stays bounded for arbitrarily long streams."""
        mesh = self.mesh
        seq = cs = None
        refs = None
        payloads = iter_frames(path)
        parsed = {}     # decode index -> entry (pending window)
        produced = {}
        done = {}
        recon = {}
        n_parsed = 0
        eos = False
        pos0 = 0
        self.last_level_sizes = levels = []
        reorder = {}
        last_output = -1
        yielded_upto = -1
        zeros = {}

        def used_slots(nf):
            """Reference slots any block actually reads. Thor's RA
            reference lists always include the previously decoded frame
            even when no block selects it, which would falsely serialize
            the whole stream; the exact per-block ref indices are parsed,
            so the dependency graph uses them: every non-intra block reads
            ref_idx0 (dir -1, from an intra-derived merge candidate,
            reconstructs as unidirectional L0), ref_idx1 only under
            bidirectional dir == 2."""
            inter = nf.mode != MODE_INTRA
            return set(nf.ref_idx0[inter].tolist()) \
                | set(nf.ref_idx1[inter & (nf.dir == 2)].tolist())

        def deps(i):
            ent = parsed[i]
            if 'deps_cache' not in ent:
                fh = ent['nf'].hdr
                ra = [fh.ref_array[k] for k in range(fh.num_ref)]
                srcs = [ent['refs_window'][ra[s]]
                        for s in used_slots(ent['nf'])
                        if s < len(ra) and ra[s] >= 0]
                if ent['interp_pair']:
                    # resynthesis needs the pair whether or not a block
                    # selects the interpolated slot
                    srcs.extend(ent['interp_pair'])
                ent['deps_cache'] = srcs
            return ent['deps_cache']

        def ready(i):
            return all(s.producer is None or produced.get(s.producer, False)
                       for s in deps(i))

        def parse_more():
            nonlocal seq, cs, refs, n_parsed, eos, pos0
            while not eos and n_parsed - len(done) < self.lookahead:
                payload = next(payloads, None)
                if payload is None:
                    eos = True
                    return
                if seq is None:
                    # the first length-prefixed payload carries the
                    # sequence header AND the first frame
                    br = BitReader(payload)
                    seq = SequenceHeader.read(br)
                    cs = seqhdr_from_python(seq)
                    pos0 = br.pos
                    refs = [_Placeholder(0, None)] * MAX_REF_FRAMES
                nums = [r.frame_num for r in refs]
                nf = self._parse_frame(seq, cs, payload, pos0, nums)
                pos0 = 0
                fh = nf.hdr
                entry = {'nf': nf, 'nums': nums, 'interp_pair': None,
                         'refs_window': list(refs)}
                if needs_interp(fh):
                    entry['interp_pair'] = (refs[fh.ref_array[1]],
                                            refs[fh.ref_array[2]])
                parsed[n_parsed] = entry
                refs = [_Placeholder(fh.display_frame_num, n_parsed)] \
                    + refs[:-1]
                n_parsed += 1

        def zero_ref(slot):
            """Padded zero planes on `slot`: the window's first frames,
            and a listed reference no block reads."""
            if slot not in zeros:
                H, W = seq.height, seq.width
                with slot.active():
                    zeros[slot] = Made((torch.zeros(
                        (h + 2 * p, w + 2 * p), dtype=torch.uint8,
                        device=slot.device) for h, w, p in (
                            (H, W, PAD_Y), (H // 2, W // 2, PAD_C),
                            (H // 2, W // 2, PAD_C))), slot)
            return zeros[slot]

        def ref_made(r, slot):
            """The padded planes of window entry `r` for a frame on
            `slot`, as Made."""
            if r.producer is None or not produced.get(r.producer, False):
                return zero_ref(slot)
            fr = recon[r.producer]
            if fr.ref is None:      # reconstructed by another process
                with slot.active():
                    fr.ref = Made((edge_pad(torch.from_numpy(p).to(
                        slot.device), n) for p, n in zip(
                            fr.host, (PAD_Y, PAD_C, PAD_C))), slot)
            return fr.ref

        synth = (lambda s, *a: run_interp(s.device, *a)) if self.fused \
            else (lambda s, *a: interp.interpolate_frames(*a))

        def interp_made(ent, slot):
            """The interpolated reference of a frame, synthesized on its
            slot (offsets as dec/decoder.Decoder.interp_pair): a replay on
            the slot's lane, or stage by stage."""
            r1, r2 = ent['interp_pair']
            dfn = ent['nf'].hdr.display_frame_num
            off1 = r2.frame_num - dfn
            off2 = dfn - r1.frame_num
            if off1 < 0 and off2 < 0:
                off1, off2 = -off1, -off2
            if off1 == off2:
                off1 = off2 = 1
            with slot.active():
                p1, p2 = (RefFrame(*ref_made(r, slot).on(slot), r.frame_num)
                          for r in (r1, r2))
                out = synth(slot, p1, p2, off1 + off2, off2)
                return Made(out[3:], slot)

        while True:
            parse_more()
            pend = [i for i in sorted(parsed) if not done.get(i)]
            if not pend:
                break
            level = [i for i in pend if ready(i)]
            if not level:
                raise ValueError("dependency cycle in the reference "
                                 "structure")
            if self.level_chunk:
                level = level[:self.level_chunk]
            levels.append(len(level))
            work = []
            for j, i in enumerate(level):
                row = mesh.row_of(j)
                if row not in mesh.rows:
                    work.append(None)
                    continue
                s0 = mesh.slots[row][0]
                ent = parsed[i]
                nf = ent['nf']
                cfg, inp, slots = build_frame_inputs(nf, seq, ent['nums'])
                clamped = inp.get("mc_clamped", 0)
                if clamped:
                    self.mc_clamped += clamped
                    warnings.warn(
                        f"frame {nf.hdr.display_frame_num}: {clamped} MC "
                        "windows leave the padded reference and were "
                        "clamped")
                window = ent['refs_window']
                interp_ref = interp_made(ent, s0) if ent['interp_pair'] \
                    else None
                work.append((cfg, inp, [
                    ref_made(window[r], s0) if r >= 0 else interp_ref
                    for r in slots]))
            results = sharded_reconstruct(mesh, work, seq.bipred,
                                          fused=self.fused)
            mine = {}
            for j, i in enumerate(level):
                if results[j] is not None:
                    planes, padded = results[j]
                    with planes.slot.active():
                        recon[i] = _Frame(_Output(planes.tensors), padded)
                    if mesh.shared:
                        mine[i] = recon[i].planes()
            if mesh.shared:
                for i, host in fetch_to_host(mine).items():
                    if i not in recon:
                        recon[i] = _Frame(host=host)
            for i in level:
                produced[i] = True
                done[i] = True
                reorder[parsed[i]['nf'].hdr.display_frame_num
                        % MAX_REORDER_BUFFER] = i

            # display-order output (dec/maindec.c:176-195)
            while True:
                nxt = (last_output + 1) % MAX_REORDER_BUFFER
                if nxt not in reorder:
                    break
                last_output += 1
                i = reorder.pop(nxt)
                yielded_upto = max(yielded_upto, i)
                yield recon[i].planes()

            # release: a reconstructed frame can still be referenced
            # while inside any future frame's 33-deep sliding window;
            # once every pending/unparsed frame's window excludes it AND
            # it has been yielded, drop it (bounded memory)
            floor = min(pend) if pend else n_parsed
            held = set(reorder.values())
            for i in [k for k in recon
                      if k < min(floor, yielded_upto + 1) - MAX_REF_FRAMES
                      and k not in held]:
                del recon[i]
                del parsed[i]

        # tail of the reorder buffer
        for k in range(1, MAX_REORDER_BUFFER + 1):
            nxt = (last_output + k) % MAX_REORDER_BUFFER
            if nxt in reorder:
                yield recon[reorder.pop(nxt)].planes()
            else:
                break

