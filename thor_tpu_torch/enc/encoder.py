"""Sequence and frame level of the encoder.

Counterpart of thor_tpu/enc/encoder.py. Mirrors enc/mainenc.c (GOP
structure, frame typing, QP cascade, reference-list construction) and
enc/encode_frame.c (lambda model, frame header, in-loop filters, CLPF
decision, sliding-window references), with encoder checkpoints
(utils/checkpoint.py) in the sequence loop.

Two encoders share it, as in thor_tpu. The host mirror encoder
(device_encode=0, the default) runs the reference RD search block by
block in numpy on the host (enc/host.py, enc/block.py). The device
encoder (device_encode=1) codes I frames (enc/device_intra) and P and B
frames (enc/device_inter) on the encoder's device; a P or B frame whose
reference is missing takes the mirror. Either way the references, the
interpolated reference of RA configurations (ops/interp), the
reconstruction and the in-loop filters live on the encoder's device;
block syntax, the decisions and the CLPF bits are host work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..bitstream.writer import BitWriter
from ..codec.blockdata import DeblockData
from ..codec.constants import (
    BETA_TABLE, B_FRAME, CHROMA_QP, I_FRAME, MAX_BLOCK_SIZE,
    MAX_NUM_INTRA_MODES, MAX_REF_FRAMES, MAX_REORDER_BUFFER,
    PAD_C, PAD_Y, P_FRAME, SQUARED_LAMBDA_QP, TC_TABLE)
from ..device import resolve_device
from ..ops import kernels as K
from ..ops.interp import interpolate_frames
from ..ops.interp_fused import run_interp
from ..utils.checkpoint import load_encoder_state, save_encoder_state
from ..utils.tracing import count_wait, span, waits
from .device_inter import (clpf_apply, clpf_cand_masks, clpf_sb_sums,
                           finish_inter_frame_device,
                           measure_inter_frame_device)
from .device_intra import encode_intra_frame_device
from .fused_intra import encode_intra_frame_fused
from .host import HostMirror, HostRef

I32 = torch.int32
# a frame span's name: enc.frame.<kind>
FRAME_KIND = {I_FRAME: "I", P_FRAME: "P", B_FRAME: "B"}


@dataclass
class EncoderParams:
    """Typed flag registry with reference defaults
    (enc/strings.c:286-338)."""
    width: int = 1920
    height: int = 1080
    qp: int = 32
    num_frames: int = 600
    skip: int = 0
    frame_rate: float = 60.0
    lambda_coeffI: float = 1.0
    lambda_coeffP: float = 1.0
    lambda_coeffB: float = 1.0
    lambda_coeffB0: float = 1.0
    lambda_coeffB1: float = 1.0
    lambda_coeffB2: float = 1.0
    lambda_coeffB3: float = 1.0
    early_skip_thr: float = 0.0
    enable_tb_split: int = 0
    enable_pb_split: int = 0
    max_num_ref: int = 1
    HQperiod: int = 1
    num_reorder_pics: int = 0
    dyadic_coding: int = 1
    interp_ref: int = 0
    dqpP: int = 0
    dqpB: int = 0
    dqpB0: int = 0
    dqpB1: int = 0
    dqpB2: int = 0
    dqpB3: int = 0
    mqpP: float = 1.0
    mqpB: float = 1.0
    mqpB0: float = 1.0
    mqpB1: float = 1.0
    mqpB2: float = 1.0
    mqpB3: float = 1.0
    dqpI: int = 0
    intra_period: int = 0
    intra_rdo: int = 0
    rdoq: int = 0
    max_delta_qp: int = 0
    delta_qp_step: int = 1
    encoder_speed: int = 0
    sync: int = 0
    deblocking: int = 1
    clpf: int = 1
    snrcalc: int = 1
    use_block_contexts: int = 0
    enable_bipred: int = 0
    file_headerlen: int = 0     # -ph (enc/strings.c:288)
    frame_headerlen: int = 0    # -fh (enc/strings.c:289)
    device_encode: int = 0

    @classmethod
    def in_code(cls, **fields):
        """EncoderParams built in code from `fields`, the float fields
        stored as from_config_file stores them (through float32)."""
        return cls(**fields)._float32()

    def _float32(self, **overrides):
        for k, v in overrides.items():
            setattr(self, k, v)
        # The reference stores ARG_FLOAT params as C float (32-bit,
        # enc/mainenc.h:48-71); round-trip through float32 so products
        # like lambda_coeffP * squared_lambda_QP match bit for bit.
        for f in FLOAT_PARAMS:
            setattr(self, f, float(np.float32(getattr(self, f))))
        return self

    @classmethod
    def from_config_file(cls, path: str, **overrides):
        """Parse a reference -cf config file (enc/strings.c:64-123,
        137-265): whitespace tokens, `;` comments to end of line,
        quoted strings, recursive nested -cf includes."""
        p = cls()
        apply_args(config_tokens(path), p, {})
        return p._float32(**overrides)


# ARG_FLOAT params (enc/strings.c:298-306, 320-325)
FLOAT_PARAMS = (
    "frame_rate", "lambda_coeffI", "lambda_coeffP", "lambda_coeffB",
    "lambda_coeffB0", "lambda_coeffB1", "lambda_coeffB2",
    "lambda_coeffB3", "early_skip_thr", "mqpP", "mqpB", "mqpB0",
    "mqpB1", "mqpB2", "mqpB3")

# Flags whose name differs from the EncoderParams field
# (enc/strings.c:286-298)
FLAG_ALIAS = {"-n": "num_frames", "-f": "frame_rate",
              "-ph": "file_headerlen", "-fh": "frame_headerlen"}
FILE_FLAGS = {"-if": "if", "-of": "of", "-rf": "rf", "-stat": "stat"}


def config_tokens(path: str):
    """Tokenize a config file exactly like read_config_file
    (enc/strings.c:64-123): whitespace-separated tokens; a token
    starting with `;` discards the rest of its line; `"..."` reads a
    string up to the closing quote, comma or newline."""
    toks = []
    with open(path) as f:
        for line in f:
            i, n = 0, len(line)
            while i < n:
                while i < n and line[i].isspace():
                    i += 1
                if i >= n:
                    break
                if line[i] == ';':
                    break
                if line[i] == '"':
                    j = i + 1
                    while j < n and line[j] not in '",\n':
                        j += 1
                    toks.append(line[i + 1:j])
                    i = j + 1
                else:
                    j = i
                    while j < n and not line[j].isspace():
                        j += 1
                    toks.append(line[i:j])
                    i = j
    return toks


def _atoi(s: str) -> int:
    """C atoi: leading integer prefix, 0 if none."""
    s = s.strip()
    m = 0
    sign = 1
    i = 0
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j > i:
        m = int(s[i:j])
    return sign * m


def apply_args(args, params: "EncoderParams", files: dict):
    """Apply a flag token stream to (params, files) with the reference
    parse_params semantics (enc/strings.c:137-265): recursive -cf,
    unknown parameters are fatal (ValueError)."""
    i = 0
    n = len(args)
    while i < n:
        a = args[i]
        if a == "-cf":
            if i + 1 >= n:
                raise ValueError("No filename found for parameter: -cf")
            apply_args(config_tokens(args[i + 1]), params, files)
            i += 2
            continue
        if a in FILE_FLAGS:
            if i + 1 >= n:
                raise ValueError(f"No filename found for parameter: {a}")
            files[FILE_FLAGS[a]] = args[i + 1]
            i += 2
            continue
        name = FLAG_ALIAS.get(a, a[1:] if a.startswith("-") else "")
        if not name or name.startswith("_") or \
                name not in params.__dataclass_fields__:
            raise ValueError(f"Unknown parameter: {a}")
        if i + 1 >= n:
            raise ValueError(f"No value found for parameter: {a}")
        val = args[i + 1]
        if name in FLOAT_PARAMS:
            setattr(params, name, float(np.float32(float(val))))
        else:
            setattr(params, name, _atoi(val))
        i += 2


class RefFrame:
    """Padded reference (create_reference_frame,
    common/common_frame.c:464-483): uint8 planes on the encoder's device,
    edge-padded by 96 (luma) / 48 (chroma), and the display number."""

    def __init__(self, y, u, v, frame_num):
        self.frame_num = frame_num
        self.y = K.edge_pad(y, PAD_Y)
        self.u = K.edge_pad(u, PAD_C)
        self.v = K.edge_pad(v, PAD_C)
        self._host = None

    @classmethod
    def of_padded(cls, yp, up, vp, frame_num, host=None):
        """A reference from planes that already carry the codec padding
        (the interpolated frame's synthesis writes them so; a checkpoint
        holds them so, and passes its numpy planes as the host copy)."""
        ref = cls.__new__(cls)
        ref.frame_num = frame_num
        ref.y, ref.u, ref.v = yp, up, vp
        ref._host = host
        return ref

    def host(self):
        """The host mirror's copy of the padded planes (enc/host.HostRef),
        copied from the device on the first call."""
        if self._host is None:
            self._host = HostRef(*(t.cpu().numpy()
                                   for t in (self.y, self.u, self.v)),
                                 self.frame_num)
        return self._host


class Encoder:
    """Top-level encoder (the mainenc.c loop) on `device` ("cuda" by
    default; "cpu" runs the kernels' plain versions). `frame_times` holds
    one dict per encoded frame: the host-clock seconds of its stages, each
    ending where the host waits for the device anyway (host mirror
    frames: search, filters; device I frames: search, scan (with
    fused=True the filters' device work too), emit, filters, with the TU
    count "tus"; device P and B frames: measure (or,
    with fused=False, me, trials and intra_search), decide,
    second_chance, final, emit, filters, with the counts "pus" of the MC
    and "intra_leaves" of the intra scan), and, from encode_sequence,
    "waits": the places the frame's host needed a device result
    (utils/tracing.count_wait). Each stage is a span (utils/tracing.span)
    named enc.<stage>, inside the frame's span enc.frame.<I|P|B> (its
    args: the frame number) beside enc.upload (the frame's copy to the
    device), so a torch.profiler trace sets the card's idle gaps against
    them. With record=True,
    `device_record` holds one record per device P/B frame, the inputs of
    its device work on the device, for
    enc/device_inter.replay_device_frame, and `intra_record` one per
    device I frame, for enc/fused_intra.replay_intra_frame.

    fused=True (the default; thor_tpu's fused dispatch) runs a device P/B
    frame's device work as the three programs of enc/fused.py, one CUDA
    graph each per signature on a card: measure, the second chance's
    trials, and the final reconstruction with the in-loop filters, whose
    CLPF bits the host then writes from the fetched decision
    (_filters_done, thor_tpu's _filters_done_on_device); a device I frame
    as the two programs of enc/fused_intra.py (the search; the scans with
    the filters), its CLPF bits written the same way; and the
    interpolated reference of RA configurations as one graph per
    signature (ops/interp_fused.py). A capture that fails raises.
    fused=False runs the stages one by one (enc/device_inter,
    enc/device_intra, ops/interp) and the filters in _filters."""

    def __init__(self, params: EncoderParams, device=None,
                 record: bool = False, fused: bool = True):
        self.device = resolve_device(device)
        self.fused = fused
        if params.device_encode:
            if params.width % 8 or params.height % 8:
                raise ValueError("the device encoder needs a width and a "
                                 "height that are multiples of 8: thor_tpu's "
                                 "device encoder, the reference it is held "
                                 "to, fails on other sizes "
                                 "(thor_tpu/enc/device_intra.py:649)")
            if min(params.width, params.height) < MAX_BLOCK_SIZE \
                    and params.intra_period != 1:
                raise ValueError(
                    "the device encoder codes P and B frames only where a "
                    "whole 64x64 superblock fits: their check against "
                    "thor_tpu is open, since thor_tpu's device ME fails on "
                    "such frames (thor_tpu/ops/windowed.py:85); set "
                    "intra_period=1")
        elif params.width % 8 or params.height % 8:
            raise ValueError("the host mirror encoder needs a width and a "
                             "height that are multiples of 8: thor_tpu's "
                             "mirror, the reference it is held to, fails "
                             "in its luma deblocking on other sizes "
                             "(thor_tpu/ops/np_kernels.py:376)")
        self.params = params
        self.width = params.width
        self.height = params.height
        p = params
        # Frame-level state
        self.frame_type = I_FRAME
        self.frame_qp = p.qp
        self.frame_num = 0
        self.num_ref = 0
        self.ref_array: List[int] = []
        self.interp_ref = 0
        self.b_level = 0
        self.num_intra_modes = MAX_NUM_INTRA_MODES
        self.lambda_ = 1.0
        self.max_delta_qp = p.max_delta_qp
        self.enable_bipred = p.enable_bipred
        self.last_intra_frame_num = 0
        self.frame_times: List[dict] = []

        self.refs: List[Optional[RefFrame]] = [None] * MAX_REF_FRAMES
        self.interp_frame: Optional[RefFrame] = None
        self.deblock_data = DeblockData(self.width, self.height)

        # uint8 planes on the device: the frame being coded and its
        # reconstruction; rec_host, the reconstruction's numpy planes when
        # a fused P/B frame fetched them already (else None)
        self.rec_y = self.rec_u = self.rec_v = None
        self.rec_host = None
        # a fused I frame's padded reference planes (else None)
        self.rec_padded = None
        self.org_y = self.org_u = self.org_v = None
        self.mirror = HostMirror(self)
        # the GOP-parallel planner (parallel/encode.py) sets _defer_interp:
        # _synth_interp then records its arguments in _pending_interp
        self._defer_interp = False
        self._pending_interp = None
        # record=True: one dict per device P/B frame, in coding order, that
        # enc/device_inter.replay_device_frame runs again; record_keys are
        # the references a record already holds or makes
        self.device_record = [] if record else None
        self.intra_record = [] if record else None
        self.record_keys = set()

    def store_deblock_data(self, binfo):
        """copy_deblock_data (enc/encode_block.c) on final encode."""
        bp = binfo.block_param
        pb_part_stored = bp.pb_part if bp.mode == 2 else 0
        cbp = bp.cbp
        cbp_flat = (1 if cbp[0] else 0, 1 if cbp[1] else 0,
                    1 if cbp[2] else 0)
        self.deblock_data.store_block(
            binfo.ypos, binfo.xpos, binfo.bwidth, binfo.bheight, binfo.size,
            bp.mode, cbp_flat, bp.tb_split, pb_part_stored,
            bp.mv_arr0, bp.mv_arr1, bp.ref_idx0, bp.ref_idx1, bp.dir)

    # --- frame level ---

    def encode_frame(self, w: BitWriter):
        """enc/encode_frame.c:65-194."""
        self.encode_frame_finish(w, self.encode_frame_begin(w))

    def encode_frame_begin(self, w: BitWriter):
        """Lambda and frame header, then either the whole encode of an I
        frame (search, exact scan, block syntax, filters; returns None) or
        the measurement half of a P or B frame (returns its context for
        encode_frame_finish)."""
        p = self.params
        self.deblock_data.reset()
        self.rec_host = self.rec_padded = None
        if self.frame_type == I_FRAME:
            lambda_coeff = p.lambda_coeffI
        elif self.frame_type == P_FRAME:
            lambda_coeff = p.lambda_coeffP
        else:
            lambda_coeff = [p.lambda_coeffB0, p.lambda_coeffB1,
                            p.lambda_coeffB2, p.lambda_coeffB3,
                            ][self.b_level] if self.b_level < 4 \
                else p.lambda_coeffB
        self.lambda_ = lambda_coeff * SQUARED_LAMBDA_QP[self.frame_qp]

        w.putbits(1, int(self.frame_type != I_FRAME))
        w.putbits(8, self.frame_qp)
        w.putbits(4, self.num_intra_modes)
        if self.frame_type != I_FRAME:
            w.putbits(2, self.num_ref - 1)
        for r in self.ref_array:
            w.putbits(6, r + 1)
        w.putbits(16, self.frame_num)

        self.frame_times.append({})
        org = tuple(t.to(I32) for t in (self.org_y, self.org_u, self.org_v))
        # thor_tpu/enc/encoder.py:608-613; __init__'s size check covers
        # the rest of its rule
        rec = None
        if p.device_encode and self.frame_type == I_FRAME:
            if self.fused:
                out = encode_intra_frame_fused(self, w, *org)
                self._filters_done(w, out)
                self.rec_padded = out["padded"]
                return None
            y, u, v = encode_intra_frame_device(self, w, *org)
            if self.intra_record is not None:
                rec = self.intra_record[-1]
        elif p.device_encode and all(self.get_ref(i) is not None
                                     for i in range(self.num_ref)):
            return measure_inter_frame_device(self, *org)
        else:
            with span("enc.search", self.frame_times[-1], "search"):
                y, u, v = (torch.from_numpy(a).to(self.device, I32)
                           for a in self.mirror.encode_frame(w))
        self._filters(w, y, u, v, org[0], rec)
        return None

    def encode_frame_finish(self, w: BitWriter, ctx=None):
        """Drain a P/B frame's measurement context (the decision walk, the
        final reconstruction, the emit, the filters), then the
        sliding-window reference update."""
        ref = None
        if ctx is not None:
            out = finish_inter_frame_device(self, w, ctx)
            rec = ctx.get("rec")
            if ctx["fused"]:
                self._filters_done(w, out)
                ref = RefFrame.of_padded(*out["padded"], self.frame_num)
            else:
                self._filters(w, *out, ctx["org"][0], rec)
            if rec is not None:
                self.device_record.append(rec)
                self.record_keys.add(("r", self.frame_num))
        if ref is None and self.rec_padded is not None:
            ref = RefFrame.of_padded(*self.rec_padded, self.frame_num)
        if ref is None:
            ref = RefFrame(self.rec_y, self.rec_u, self.rec_v,
                           self.frame_num)
        self.refs = [ref] + self.refs[:-1]
        if not self.params.device_encode:
            self.refs[0].host()     # the mirror reads every reference

    def get_ref(self, ref_idx):
        """The reference of slot ref_idx: a window frame, or the
        interpolated frame where ref_array holds -1."""
        r = self.ref_array[ref_idx]
        return self.refs[r] if r >= 0 else self.interp_frame

    def _filters(self, w, y, u, v, org_y, rec=None):
        """Deblocking and the CLPF decision of the unfiltered int32 planes
        (y, u, v) from the side-info map; sets rec_y / rec_u / rec_v (uint8
        on the device) and the frame's "filters" time. A frame's record
        `rec` gets what a replay of the filters reads: the flags, the
        packed side-info map and the CLPF candidate masks, on the
        device."""
        p = self.params
        H, W = self.height, self.width
        with span("enc.filters", self.frame_times[-1], "filters"):
            if rec is not None:
                rec.update(deblocking=bool(p.deblocking), clpf_cand=None)
            if p.deblocking:
                qp = self.frame_qp
                ddp = self._deblock_fields()
                if rec is not None:
                    rec["ddp"] = ddp
                dd = K.unpack_ddp(ddp)
                tc_c = int(TC_TABLE[CHROMA_QP[qp]])
                y = K.deblock_luma(y, dd, H, W, int(BETA_TABLE[qp]),
                                   int(TC_TABLE[qp]))
                u = K.deblock_chroma(u, dd, H, W, tc_c)
                v = K.deblock_chroma(v, dd, H, W, tc_c)
            if p.clpf:
                w.putbits(1, 1)
                w.putbits(1, 0)     # sb_signal: per-SB decision bits follow
                y, u, v = self._clpf_frame(w, y, u, v, org_y, rec)
            self.rec_y, self.rec_u, self.rec_v = (
                t.to(torch.uint8) for t in (y, u, v))
            # the sequence loop reads the frame back right after this, so
            # waiting here costs nothing and closes the stage's time; only
            # this stream, so frames on other streams go on
            count_wait()
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def _filters_done(self, w, out):
        """The filters of a fused frame ran in its final program
        (enc/fused.py, enc/fused_intra.py): write the CLPF bits from the
        fetched decision out["bit_sb"] over the candidates of the emit's
        side-info map, and take the filtered planes (rec_y / rec_u /
        rec_v on the device, rec_host fetched)."""
        with span("enc.filters", self.frame_times[-1], "filters"):
            if self.params.clpf:
                w.putbits(1, 1)
                w.putbits(1, 0)     # sb_signal: per-SB decision bits follow
                self._write_clpf_bits(w, self._clpf_candidates()[1],
                                      out["bit_sb"])
            self.rec_y, self.rec_u, self.rec_v = out["planes"]
            self.rec_host = out["host"]

    def _deblock_fields(self):
        """The side-info map packed as the deblocking ops read it (the
        decoder's plane, ops/kernels.pack_ddp), on the device."""
        dd = self.deblock_data
        ddp = K.pack_ddp({k: getattr(dd, k) for k in (
            "size", "tb_split", "pb_part", "mode", "cbp_y", "mv0x", "mv0y",
            "mv1x", "mv1y")})
        return torch.from_numpy(ddp).to(self.device)

    def _clpf_candidates(self):
        """The CLPF candidates of the side-info map: its three [H/8, W/8]
        masks (clpf_cand_masks) and the [SBH, SBW] superblocks they
        touch."""
        H, W = self.height, self.width
        SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
        c8 = clpf_cand_masks(self.deblock_data, H, W)
        cand_sb = (c8[0] | c8[1] | c8[2])[:SBH * 8, :SBW * 8] \
            .reshape(SBH, 8, SBW, 8).any(axis=(1, 3))
        return c8, cand_sb

    @staticmethod
    def _write_clpf_bits(w: BitWriter, cand_sb, bit_sb):
        """The CLPF's per-superblock bits (common/common_frame.c:485-557):
        the decision bit_sb of each candidate superblock in raster
        order."""
        for k, l in zip(*np.nonzero(cand_sb)):
            w.putbits(1, 1 if bit_sb[k, l] else 0)

    def _clpf_frame(self, w: BitWriter, y, u, v, org_y, rec=None):
        """clpf_frame with the encoder's decision (common/common_frame.c:
        485-557, clpf_decision enc/encode_frame.c:50-61, detect_clpf
        enc/encode_block.c:3036). The planes are filtered whole on the
        device (the decoder's op) and the luma squared errors with and
        without the filter are summed per superblock there; only those
        sums come to the host, which writes one bit per candidate
        superblock. Returns the filtered (y, u, v)."""
        H, W = self.height, self.width
        c8, cand_sb = self._clpf_candidates()
        if not cand_sb.any():
            return y, u, v

        dev = self.device
        c8 = tuple(torch.from_numpy(a).to(dev) for a in c8)
        if rec is not None:
            rec["clpf_cand"] = c8
        sums = clpf_sb_sums(y, org_y, c8[0], H, W).cpu().numpy()
        bit_sb = sums[1] < sums[0]
        self._write_clpf_bits(w, cand_sb, bit_sb)

        on_sb = cand_sb & bit_sb
        if not on_sb.any():
            return y, u, v
        h8, w8 = on_sb.shape[0] * 8, on_sb.shape[1] * 8
        on8 = np.zeros((H // 8, W // 8), bool)
        on8[:h8, :w8] = np.repeat(np.repeat(on_sb, 8, 0), 8, 1)
        return clpf_apply(y, u, v, c8, torch.from_numpy(on8).to(dev), H, W)

    # --- sequence level ---

    def encode_sequence(self, frames, out_path: str,
                        checkpoint_path: str = None,
                        checkpoint_every: int = 0,
                        resume_path: str = None):
        """Full sequence loop (enc/mainenc.c:214-604): sub-GOP reorder
        (dyadic or sequential), frame typing, QP cascade, reference-list
        construction (LDB sliding window / dyadic RA / non-dyadic HDB
        incl. interpolated-reference insertion), duplicate and
        random-access pruning, end-of-sequence PPP degradation, and
        display-order reconstruction output.

        frames: full input clip as a list of (y, u, v) uint8 numpy planes
        (display order). Returns the reconstructed frames in display
        order, as numpy planes.

        checkpoint_path + checkpoint_every=N: snapshot the reference
        window and the loop counters every N encoded frames, at sub-GOP
        boundaries (utils/checkpoint.save_encoder_state, thor_tpu's file
        format). resume_path: restore such a snapshot and continue; the
        stream is truncated to the recorded byte offset and appended to,
        byte-identical to an uninterrupted encode, and the return value
        covers only the newly encoded frames."""
        p = self.params
        frames = list(frames)
        input_total = len(frames)
        w = BitWriter()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

        if resume_path is not None:
            loop = load_encoder_state(self, resume_path)
            out = open(out_path, "r+b")
            out.truncate(loop["stream_bytes"])
            out.seek(loop["stream_bytes"])
            sub_gop = loop["sub_gop"]
            p.num_reorder_pics = loop["num_reorder_pics"]
            p.HQperiod = loop["HQperiod"]
            num_encoded = loop["num_encoded"]
            last_PorI = loop["last_PorI"]
            self.last_intra_frame_num = loop["last_intra_frame_num"]
            frame_num0 = loop["frame_num0"]
        else:
            out = open(out_path, "wb")
            # Sequence header (enc/mainenc.c:195-212)
            w.putbits(16, self.width)
            w.putbits(16, self.height)
            w.putbits(1, p.enable_pb_split)
            w.putbits(1, p.enable_tb_split)
            w.putbits(2, p.max_num_ref - 1)
            w.putbits(1, p.interp_ref)
            w.putbits(3, p.max_delta_qp)
            w.putbits(1, p.deblocking)
            w.putbits(1, p.clpf)
            w.putbits(1, p.use_block_contexts)
            w.putbits(1, p.enable_bipred)
            sub_gop = max(1, p.num_reorder_pics + 1)
            num_encoded = 0
            last_PorI = -1
            self.last_intra_frame_num = 0
            frame_num0 = p.skip
        min_interp_depth = _log2i(p.num_reorder_pics + 1) - 2
        if p.frame_rate > 30:
            min_interp_depth -= 1

        rec_avail = {}
        last_output = -1 if resume_path is None \
            else frame_num0 - p.skip - 1
        display = []
        with out:
            while (frame_num0 < p.skip + p.num_frames
                   and frame_num0 + 1 <= input_total):
                for k in range(sub_gop):
                    offset = _reorder_frame_offset(k, sub_gop,
                                                   p.dyadic_coding)
                    frame_num = frame_num0 + offset
                    if frame_num < p.skip:
                        continue
                    self.frame_num = frame_num - p.skip
                    w0 = waits()
                    kind = FRAME_KIND[self._frame_type(num_encoded,
                                                       sub_gop)]
                    with span("enc.frame." + kind, args=str(self.frame_num)):
                        self._setup_frame(num_encoded, sub_gop,
                                          min_interp_depth, last_PorI)
                        with span("enc.upload"):
                            self.org_y, self.org_u, self.org_v = (
                                upload(a, self.device)
                                for a in frames[frame_num])
                        self.encode_frame(w)
                        out.write(w.flush_frame())
                        rec = self.rec_host
                        if rec is None:
                            count_wait()
                            rec = tuple(t.cpu().numpy() for t in (
                                self.rec_y, self.rec_u, self.rec_v))
                    self.frame_times[-1]["waits"] = waits() - w0
                    num_encoded += 1
                    rec_avail[self.frame_num % MAX_REORDER_BUFFER] = rec
                    nxt = (last_output + 1) % MAX_REORDER_BUFFER
                    if nxt in rec_avail:
                        last_output += 1
                        display.append(rec_avail.pop(nxt))
                    last_PorI = 0 if self.frame_type != B_FRAME \
                        else last_PorI + 1
                # Revert to PPP when the sub-GOP no longer fits
                # (enc/mainenc.c:586-590)
                if ((frame_num0 + sub_gop + 1 > input_total
                     or frame_num0 + sub_gop >= p.skip + p.num_frames)
                        and sub_gop >= 2):
                    p.HQperiod = sub_gop
                    sub_gop = 1
                    p.num_reorder_pics = 0
                frame_num0 += sub_gop
                if (checkpoint_path and checkpoint_every
                        and num_encoded % checkpoint_every == 0):
                    out.flush()
                    save_encoder_state(self, checkpoint_path, {
                        "frame_num0": frame_num0,
                        "num_encoded": num_encoded,
                        "last_PorI": last_PorI,
                        "last_intra_frame_num": self.last_intra_frame_num,
                        "sub_gop": sub_gop,
                        "num_reorder_pics": p.num_reorder_pics,
                        "HQperiod": p.HQperiod,
                        "stream_bytes": out.tell()})
        for i in range(1, MAX_REORDER_BUFFER + 1):
            nxt = (last_output + i) % MAX_REORDER_BUFFER
            if nxt in rec_avail:
                display.append(rec_avail.pop(nxt))
            else:
                break
        return display

    def _frame_type(self, num_encoded, sub_gop):
        """The type of frame self.frame_num: I, P or B by the intra
        period and the sub-GOP (the first step of _setup_frame)."""
        p = self.params
        fn = self.frame_num
        if p.num_reorder_pics == 0:
            if p.intra_period > 0:
                return I_FRAME if num_encoded % p.intra_period == 0 \
                    else P_FRAME
            return I_FRAME if num_encoded == 0 else P_FRAME
        if p.intra_period > 0:
            return I_FRAME if fn % p.intra_period == 0 else (
                P_FRAME if fn % sub_gop == 0 else B_FRAME)
        return I_FRAME if fn == 0 else (
            P_FRAME if fn % sub_gop == 0 else B_FRAME)

    def _setup_frame(self, num_encoded, sub_gop, min_interp_depth,
                     last_PorI):
        """Frame type, QP cascade and reference-list construction
        (enc/mainenc.c:236-495)."""
        p = self.params
        fn = self.frame_num
        ftype = self._frame_type(num_encoded, sub_gop)
        self.frame_type = ftype

        coded_phase = (num_encoded + sub_gop - 2) % sub_gop + 1
        b_level = _log2i(coded_phase)
        self.b_level = b_level

        f32 = np.float32
        if ftype == I_FRAME:
            qp = p.qp + p.dqpI
            self.last_intra_frame_num = fn
        elif p.num_reorder_pics == 0:
            qp = (int(f32(p.mqpP) * f32(p.qp)) + p.dqpP
                  if num_encoded % p.HQperiod else p.qp)
        else:
            if fn % sub_gop:
                if p.dyadic_coding:
                    mqp, dqp = [(p.mqpB0, p.dqpB0), (p.mqpB1, p.dqpB1),
                                (p.mqpB2, p.dqpB2), (p.mqpB3, p.dqpB3),
                                ][b_level] if b_level < 4 \
                        else (p.mqpB, p.dqpB)
                    qp = int(f32(mqp) * f32(p.qp)) + dqp
                else:
                    qp = int(f32(p.mqpB) * f32(p.qp)) + p.dqpB
            else:
                qp = (int(f32(p.mqpP) * f32(p.qp)) + p.dqpP
                      if fn % p.HQperiod else p.qp)
        self.frame_qp = max(0, min(51, qp))

        self.num_ref = 0 if ftype == I_FRAME \
            else min(num_encoded, p.max_num_ref)
        self.interp_ref = 0
        self.interp_frame = None
        n = self.num_ref
        ref = [0] * n
        if n > 0:
            if p.num_reorder_pics > 0:
                lg = _log2i(sub_gop)
                if p.dyadic_coding:
                    if (num_encoded - 1) % sub_gop == 0:
                        ref[0] = 0 if num_encoded == 1 else sub_gop - 1
                        if n > 1:
                            ref[1] = min(MAX_REF_FRAMES - 1,
                                         min(num_encoded - 1,
                                             2 * sub_gop - 1))
                        for r in range(2, n):
                            ref[r] = r - 2
                    else:
                        display_phase = (fn - 1) % sub_gop
                        ref_offset = sub_gop >> (b_level + 1)
                        dc = _DYADIC_DC[sub_gop]
                        if b_level >= min_interp_depth and p.interp_ref:
                            if n == 2:
                                n += 1
                                ref.append(0)
                                self.num_ref = n
                            self.interp_ref = 1
                            ref[1] = min(num_encoded - 1, coded_phase
                                         - dc[display_phase - ref_offset
                                              + 1] - 1)
                            ref[2] = min(num_encoded - 1, coded_phase
                                         - dc[display_phase + ref_offset
                                              + 1] - 1)
                            ref[0] = -1
                            self._synth_interp(ref[1], ref[2], 2, 1)
                            for r in range(3, n):
                                ref[r] = r - 3
                        else:
                            ref[0] = min(num_encoded - 1, coded_phase
                                         - dc[display_phase - ref_offset
                                              + 1] - 1)
                            if n > 1:
                                ref[1] = min(num_encoded - 1, coded_phase
                                             - dc[display_phase
                                                  + ref_offset + 1] - 1)
                            for r in range(2, n):
                                ref[r] = r - 2
                else:
                    if (num_encoded - 1) % sub_gop == 0:
                        ref[0] = 0 if num_encoded == 1 else sub_gop - 1
                        if n > 1:
                            ref[1] = min(MAX_REF_FRAMES - 1,
                                         min(num_encoded - 1,
                                             2 * sub_gop - 1))
                        for r in range(2, n):
                            ref[r] = r - 1
                    else:
                        phase = (num_encoded + sub_gop - 2) % sub_gop
                        if p.interp_ref:
                            if n == 2:
                                n += 1
                                ref.append(0)
                                self.num_ref = n
                            self.interp_ref = 1
                            ref[1] = 0
                            if n > 1:
                                ref[2] = (min(sub_gop, num_encoded - 1)
                                          if phase == 0
                                          else min(phase, num_encoded - 1))
                            ref[0] = -1
                            self._synth_interp(
                                ref[1], ref[2], sub_gop - phase,
                                1 if phase != 0 else sub_gop - phase - 1)
                            if n > 2:
                                ref[3] = min(phase + sub_gop if phase
                                             else 2 * sub_gop,
                                             num_encoded - 1)
                            for r in range(4, n):
                                ref[r] = r - 4 + 1
                        else:
                            ref[0] = 0
                            if n > 1:
                                ref[1] = (min(sub_gop, num_encoded - 1)
                                          if phase == 0
                                          else min(phase, num_encoded - 1))
                            if n > 2:
                                ref[2] = min(phase + sub_gop if phase
                                             else 2 * sub_gop,
                                             num_encoded - 1)
                            for r in range(3, n):
                                ref[r] = r - 3 + 1
            else:
                # LDB sliding window (enc/mainenc.c:423-454)
                ref[0] = 0 if last_PorI < 0 else last_PorI
                if n == 2:
                    ref[1] = ((num_encoded + p.HQperiod - 2)
                              % p.HQperiod) + 1
                elif n == 3:
                    r1 = ((num_encoded + p.HQperiod - 2) % p.HQperiod) + 1
                    ref[1], ref[2] = r1, (2 if r1 == 1 else 1)
                elif n == 4:
                    r1 = ((num_encoded + p.HQperiod - 2) % p.HQperiod) + 1
                    r2 = 2 if r1 == 1 else 1
                    r3 = r2 + 1
                    if r3 == r1:
                        r3 += 1
                    ref[1], ref[2], ref[3] = r1, r2, r3
                elif n > 4:
                    for r in range(1, n):
                        ref[r] = r

        # Remove duplicates (enc/mainenc.c:457-470)
        deduped = []
        for r in ref:
            if r not in deduped:
                deduped.append(r)
        ref = deduped
        self.num_ref = len(ref)
        # Remove references breaking random access (mainenc.c:472-486)
        if fn > self.last_intra_frame_num:
            ref = [r for r in ref
                   if r < 0 or self.refs[r].frame_num
                   >= self.last_intra_frame_num]
            self.num_ref = len(ref)
        self.ref_array = ref

        if (p.intra_rdo == 0
                or (ftype != I_FRAME and p.encoder_speed > 0)):
            self.num_intra_modes = 4
        else:
            self.num_intra_modes = MAX_NUM_INTRA_MODES

    def _synth_interp(self, r1, r2, ratio, pos):
        """The interpolated reference of a B frame, synthesized from window
        frames r1 and r2 on the encoder's device exactly as the decoder
        resynthesizes it (common/temporal_interp.c:972-1053; on a card the
        ME and synthesis kernels of ops/interp): with fused, a replay of
        its signature's graph (ops/interp_fused.run_interp), else stage by
        stage.

        With _defer_interp set (the GOP-parallel planner), only the
        reference objects and the position are recorded, in
        _pending_interp: the planner synthesizes the frame once both
        references are made (thor_tpu/enc/encoder.py:1055-1070)."""
        if self._defer_interp:
            self._pending_interp = (self.refs[r1], self.refs[r2], ratio, pos)
            return
        synth = (lambda *a: run_interp(self.device, *a)) if self.fused \
            else interpolate_frames
        out = synth(self.refs[r1], self.refs[r2], ratio, pos)
        self.interp_frame = RefFrame.of_padded(out[3], out[4], out[5],
                                               self.frame_num)
        if not self.params.device_encode:
            self.interp_frame.host()


def _log2i(n: int) -> int:
    return n.bit_length() - 1


def upload(a, device):
    """A numpy plane on `device`: on a card through pinned memory, a copy
    the host does not wait for."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# Coding order <-> display order for dyadic sub-GOPs (enc/mainenc.c:48-61)
_DYADIC_CD = {1: [0], 2: [1, 0], 4: [3, 1, 0, 2],
              8: [7, 3, 1, 5, 0, 2, 4, 6],
              16: [15, 7, 3, 11, 1, 5, 9, 13, 0, 2, 4, 6, 8, 10, 12, 14]}
_DYADIC_DC = {1: [-1, 0], 2: [-2, 1, 0], 4: [-4, 2, 1, 3, 0],
              8: [-8, 4, 2, 5, 1, 6, 3, 7, 0],
              16: [-16, 8, 4, 9, 2, 10, 5, 11, 1, 12, 6, 13, 3, 14, 7, 15,
                   0]}


def _reorder_frame_offset(idx, sub_gop, dyadic):
    """enc/mainenc.c:63-71"""
    if dyadic and sub_gop > 1:
        return _DYADIC_CD[sub_gop][idx] - sub_gop + 1
    return 0 if idx == 0 else idx - sub_gop


def crop_yuv_frames(path, src_w, src_h, width, height, n):
    """Frames 0..n-1 of a src_w x src_h planar 4:2:0 file, cropped
    top-left to width x height."""
    return [(y[:height, :width].copy(), u[:height // 2, :width // 2].copy(),
             v[:height // 2, :width // 2].copy())
            for y, u, v in read_yuv_frames(path, src_w, src_h, n)]


def read_yuv_frames(path, width, height, num_frames=None,
                    file_headerlen=0, frame_headerlen=0):
    """Read frames from a planar 4:2:0 file (the whole file by default -
    the sequence loop needs the true input length for its end-of-clip
    sub-GOP degradation, enc/mainenc.c:586-590). file/frame_headerlen
    mirror -ph/-fh: a one-time file header plus a per-frame header are
    skipped (enc/mainenc.c:510)."""
    ysz, csz = width * height, (width // 2) * (height // 2)
    fsz = ysz + 2 * csz
    with open(path, "rb") as f:
        f.seek(file_headerlen)
        while num_frames is None or num_frames > 0:
            if frame_headerlen:
                f.seek(frame_headerlen, 1)
            buf = f.read(fsz)
            if len(buf) < fsz:
                return
            y = np.frombuffer(buf, np.uint8, ysz).reshape(height, width)
            u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(
                height // 2, width // 2)
            v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(
                height // 2, width // 2)
            yield y.copy(), u.copy(), v.copy()
            if num_frames is not None:
                num_frames -= 1


def encode_file(config_path, in_path, out_path, width, height, num_frames,
                device=None, **overrides):
    """Encode a planar 4:2:0 file on `device` (default "cuda") with the
    parameters of a reference config file plus overrides; returns the
    reconstructed frames in display order."""
    params = EncoderParams.from_config_file(
        config_path, width=width, height=height, num_frames=num_frames,
        **overrides)
    enc = Encoder(params, device=device)
    frames = read_yuv_frames(in_path, width, height)
    return enc.encode_sequence(frames, out_path)
