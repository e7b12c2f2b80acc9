"""Frozen copy, for the benchmark's plain reference, of
thor_tpu_torch/dec/parse.py as of the benchmark's first version; it
imports nothing of the port, and the port's later changes do not reach
it.

Sequence header (dec/maindec.c:124-147) and the instrumented Python
frame parser.

The production parse is the native C layer
(thor_tpu_torch.native.parse_frame). FrameParser is its serial Python
counterpart, a copy of thor_tpu/dec/parse.py: it mirrors the reference
parse exactly (dec/decode_frame.c:58-109 frame header,
dec/decode_block.c:474-669 quadtree and super mode, dec/read_bits.c:221-820
block syntax) and emits one BlockRec per coded block, and it counts the
bits of each syntax category and the super-mode decisions that Thordec's
statistics report prints (dec/maindec.c:197-329). Parsing depends only on
previously parsed parameters (skip / merge / MVP candidates come from the
deblock-data map), never on pixels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .reader import BitReader, get_vlc, get_vlc0_limit
from .blockdata import (
    BlockContext, DeblockData, find_block_contexts, get_mv_merge,
    get_mv_pred, get_mv_skip)
from .constants import (
    B_FRAME, CBP_TABLE, I_FRAME, MAX_BLOCK_SIZE, MAX_QUANT_SIZE,
    MIN_BLOCK_SIZE, MODE_BIPRED, MODE_INTER, MODE_INTRA, MODE_MERGE,
    MODE_SKIP, zigzag_for)


def wrap16(v: int) -> int:
    """int16 wraparound (mv_t fields are int16_t, common/types.h:105-109)."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


@dataclass
class SequenceHeader:
    width: int
    height: int
    pb_split: int
    tb_split_enable: int
    max_num_ref: int
    interp_ref: int
    max_delta_qp: int
    deblocking: int
    clpf: int
    use_block_contexts: int
    bipred: int

    @classmethod
    def read(cls, br: BitReader) -> "SequenceHeader":
        return cls(
            width=br.getbits(16),
            height=br.getbits(16),
            pb_split=br.getbits(1),
            tb_split_enable=br.getbits(1),
            max_num_ref=br.getbits(2) + 1,
            interp_ref=br.getbits(1),
            max_delta_qp=br.getbits(3),
            deblocking=br.getbits(1),
            clpf=br.getbits(1),
            use_block_contexts=br.getbits(1),
            bipred=br.getbits(1),
        )


@dataclass
class BlockRec:
    """One coded block: everything the device reconstruction needs."""
    ypos: int
    xpos: int
    size: int
    bwidth: int
    bheight: int
    mode: int
    qp: int
    intra_mode: int = 0
    tb_split: int = 0
    pb_part: int = 0
    dir: int = 0
    ref_idx0: int = 0
    ref_idx1: int = 0
    mv_arr0: tuple = ((0, 0),) * 4
    mv_arr1: tuple = ((0, 0),) * 4
    cbp: tuple = (0, 0, 0)
    coeff_y: Optional[np.ndarray] = None   # (size, size) int16
    coeff_u: Optional[np.ndarray] = None   # (size/2, size/2) int16
    coeff_v: Optional[np.ndarray] = None


@dataclass
class FrameSyntax:
    frame_type: int
    stat_frame_type: int
    qp: int
    num_intra_modes: int
    num_ref: int
    ref_array: List[int]
    interp_ref_frame: bool   # this frame uses an interpolated reference
    display_frame_num: int
    blocks: List[BlockRec] = field(default_factory=list)
    deblock_data: Optional[DeblockData] = None
    clpf_frame_enable: int = 0
    clpf_all: int = 0
    clpf_bits: Optional[np.ndarray] = None  # (sb_v, sb_h) -1 = no bit read
    bit_cats: Optional[dict] = None          # per-category bit counts
    #: per-super-mode-decode (size, stat_code) records for P/B full
    #: blocks, stat_code per the reference's super_mode_stat slots
    #: (STAT_SKIP/SPLIT/REF_IDX0/MERGE/BIPRED/INTRA/REF_IDX1+..,
    #: dec/decode_block.c:527,576,619)
    super_stat: Optional[list] = None


def read_mv(br: BitReader, mvp):
    """dec/read_bits.c:46-58 (int16 wraparound on add)."""
    code = get_vlc(10, br)
    mvdx = -((code + 1) // 2) if (code & 1) else code // 2
    code = get_vlc(10, br)
    mvdy = -((code + 1) // 2) if (code & 1) else code // 2
    return (wrap16(mvp[0] + mvdx), wrap16(mvp[1] + mvdy))


def find_index(code: int, maxrun: int, type_: int) -> int:
    """dec/read_bits.c:63-99"""
    maxrun2 = max(4, maxrun)
    if type_:
        if code == 0:
            return -1
        if code <= 5:
            return code - 1
        if code == 6:
            return maxrun2 + 1
        if code == 7:
            return maxrun2 + 2
        if code <= maxrun2 + 3:
            return code - 3
        return code - 1
    else:
        if code <= 1:
            return code
        if code == 2:
            return -1
        if code <= 5:
            return code - 1
        if code == 6:
            return maxrun2 + 1
        if code == 7:
            return maxrun2 + 2
        if code <= maxrun2 + 3:
            return code - 3
        return code - 1


def read_coeff(br: BitReader, size: int, type_: int) -> np.ndarray:
    """Coefficient run/level decode (dec/read_bits.c:101-210).

    Returns a (size, size) int16 plane (inverse zigzag applied).
    """
    qsize = min(size, MAX_QUANT_SIZE)
    N = qsize * qsize
    chroma_flag = type_ & 1
    intra_flag = (type_ >> 1) & 1
    vlc_adaptive = 1 if (intra_flag and not chroma_flag) else 0

    scoeff = np.zeros(N, dtype=np.int16)
    pos = 0

    if chroma_flag == 1:
        if br.getbits1():
            sign = br.getbits1()
            scoeff[0] = -1 if sign else 1
            pos = N

    level_mode = 1
    level = 1
    while pos < N:
        if level_mode:
            while pos < N and level > 0:
                level = get_vlc(vlc_adaptive, br)
                sign = br.getbits1() if level else 1
                scoeff[pos] = -level if sign else level
                if chroma_flag == 0:
                    vlc_adaptive = 1 if level > 3 else 0
                pos += 1
        if pos >= N:
            break

        maxrun = N - pos - 1
        if chroma_flag and size <= 8:
            code = get_vlc(10, br)
        else:
            if br.showbits(2) == 2:
                code = br.getbits(2) - 2
            else:
                code = get_vlc(2, br) - 1

        index = find_index(code, maxrun, chroma_flag)
        if index == -1:
            break

        maxrun2 = max(4, maxrun)
        level_flag = index // (maxrun2 + 1)
        run = index % (maxrun2 + 1)
        pos += run

        if level_flag:
            tmp = get_vlc(0, br)
            sign = tmp & 1
            level = (tmp >> 1) + 2
        else:
            level = 1
            sign = br.getbits1()
        scoeff[pos] = -level if sign else level
        level_mode = 1 if level > 1 else 0
        pos += 1

    coeff = np.zeros((size, size), dtype=np.int16)
    zz = zigzag_for(qsize).reshape(qsize, qsize)
    coeff[:qsize, :qsize] = scoeff[zz]
    return coeff


def read_delta_qp(br: BitReader) -> int:
    """dec/read_bits.c:212-220"""
    abs_dqp = get_vlc(0, br)
    sign = br.getbits(1) if abs_dqp > 0 else 0
    return -abs_dqp if sign else abs_dqp


class FrameParser:
    """Parses one frame payload into a FrameSyntax."""

    def __init__(self, seq: SequenceHeader, br: BitReader,
                 ref_frame_nums):
        """ref_frame_nums: display numbers of ref[0..32] (decoder ref list)."""
        self.seq = seq
        self.br = br
        self.ref_frame_nums = ref_frame_nums
        self.dd = DeblockData(seq.width, seq.height)
        # bit_count_t analogue (common/types.h:190-217, dec/maindec.c:197-329)
        self.bits = dict.fromkeys(
            ("frame_header", "super_mode", "intra_mode", "mv", "skip_idx",
             "coeff_y", "coeff_u", "coeff_v", "cbp", "clpf"), 0)

    def parse(self) -> FrameSyntax:
        seq, br = self.seq, self.br
        _hdr0 = br.pos
        frame_type = br.getbits(1)
        qp = br.getbits(8)
        num_intra_modes = br.getbits(4)

        interp_ref_frame = False
        ref_array: List[int] = []
        if frame_type != I_FRAME:
            num_ref = br.getbits(2) + 1
            for _ in range(num_ref):
                r = br.getbits(6) - 1
                ref_array.append(r)
                if r == -1:
                    interp_ref_frame = True
            if num_ref == 2 and ref_array[0] == -1:
                ref_array.append(br.getbits(5) - 1)
                num_ref += 1
        else:
            num_ref = 0
        display_frame_num = br.getbits(16)
        self.bits["frame_header"] += br.pos - _hdr0

        stat_frame_type = frame_type
        for r in ref_array:
            if r != -1 and self.ref_frame_nums[r] > display_frame_num:
                stat_frame_type = B_FRAME

        fs = FrameSyntax(
            frame_type=frame_type, stat_frame_type=stat_frame_type, qp=qp,
            num_intra_modes=num_intra_modes, num_ref=num_ref,
            ref_array=ref_array, interp_ref_frame=interp_ref_frame,
            display_frame_num=display_frame_num, deblock_data=self.dd,
            super_stat=[])

        self.fs = fs
        self.qpb = qp
        self.mode = MODE_SKIP
        self.ref_idx = 0
        self.block_context = BlockContext()

        num_sb_hor = (seq.width + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
        num_sb_ver = (seq.height + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
        for k in range(num_sb_ver):
            for l in range(num_sb_hor):
                self.process_block(MAX_BLOCK_SIZE, k * MAX_BLOCK_SIZE,
                                   l * MAX_BLOCK_SIZE)

        # CLPF signalling (dec/decode_frame.c:130-133): read AFTER the SB
        # loop; the actual filtering happens on device post-deblock.
        if seq.clpf:
            _c0 = br.pos
            fs.clpf_frame_enable = br.getbits(1)
            if fs.clpf_frame_enable:
                fs.clpf_all = br.getbits(1)
                if not fs.clpf_all:
                    fs.clpf_bits = self._read_clpf_bits()
            self.bits["clpf"] += br.pos - _c0
        fs.bit_cats = dict(self.bits)
        return fs

    def _read_clpf_bits(self) -> np.ndarray:
        """Per-SB filter bits, read only for candidate SBs in raster order
        (clpf_frame, common/common_frame.c:499-513 with clpf_bit cb)."""
        seq, dd = self.seq, self.dd
        nsb_h = seq.width // MAX_BLOCK_SIZE
        nsb_v = seq.height // MAX_BLOCK_SIZE
        bits = np.full((nsb_v, nsb_h), -1, dtype=np.int32)
        for k in range(nsb_v):
            for l in range(nsb_h):
                cand = False
                for m in range(MAX_BLOCK_SIZE // 8):
                    for n in range(MAX_BLOCK_SIZE // 8):
                        gy = (k * MAX_BLOCK_SIZE + m * 8) // 4
                        gx = (l * MAX_BLOCK_SIZE + n * 8) // 4
                        if dd.mode[gy, gx] != MODE_BIPRED and (
                                dd.cbp_y[gy, gx] or dd.cbp_u[gy, gx]
                                or dd.cbp_v[gy, gx]):
                            cand = True
                if cand:
                    bits[k, l] = self.br.getbits(1)
        return bits

    # --- quadtree (dec/decode_block.c:625-669) ---

    def process_block(self, size, ypos, xpos):
        seq, br = self.seq, self.br
        width, height = seq.width, seq.height
        if ypos >= height or xpos >= width:
            return
        decode_this_size = (ypos + size <= height) and (xpos + size <= width)
        decode_rectangular = (not decode_this_size
                              and self.fs.frame_type != I_FRAME)

        self.block_context = find_block_contexts(
            ypos, xpos, height, width, size, self.dd,
            bool(seq.use_block_contexts))

        _s0 = self.br.pos
        split_flag = self.decode_super_mode(size, decode_this_size)
        self.bits["super_mode"] += self.br.pos - _s0

        if (size == MAX_BLOCK_SIZE
                and (split_flag or self.mode != MODE_SKIP)
                and seq.max_delta_qp > 0):
            self.qpb = self.fs.qp + read_delta_qp(br)

        if split_flag:
            h = size // 2
            self.process_block(h, ypos, xpos)
            self.process_block(h, ypos + h, xpos)
            self.process_block(h, ypos, xpos + h)
            self.process_block(h, ypos + h, xpos + h)
        elif decode_this_size or decode_rectangular:
            self.read_block(size, ypos, xpos)

    def decode_super_mode(self, size, decode_this_size) -> int:
        """dec/decode_block.c:474-622"""
        br = self.br
        fs = self.fs
        self.mode = MODE_SKIP

        if fs.frame_type == I_FRAME:
            self.mode = MODE_INTRA
            if size > MIN_BLOCK_SIZE and decode_this_size:
                return br.getbits(1)
            return 0 if decode_this_size else 1
        if not decode_this_size:
            return 0 if br.getbits(1) else 1

        num_ref = fs.num_ref
        bipred_possible = num_ref > 1 and self.seq.bipred
        split_possible = size > MIN_BLOCK_SIZE
        maxbit = 2 + num_ref + int(split_possible) + int(bipred_possible)

        code = get_vlc0_limit(maxbit, br)
        bc = self.block_context

        # super_mode_stat slot indices (common/types.h:87-93)
        STAT_SKIP, STAT_SPLIT, STAT_REF_IDX0 = 0, 1, 2
        STAT_MERGE, STAT_BIPRED, STAT_INTRA, STAT_REF_IDX1 = 3, 4, 5, 6
        stat_mode = STAT_SKIP

        if fs.interp_ref_frame:
            if (bc.index == 2 or bc.index > 3) and size > MIN_BLOCK_SIZE:
                if code < 3:
                    code = (code + 1) % 3
            if split_possible and code == 1:
                fs.super_stat.append((size, STAT_SPLIT))
                return 1
            if not split_possible and code > 0:
                code += 1
            if not bipred_possible and code >= 3:
                code += 1
            if code == 0:
                self.mode = MODE_SKIP
            elif code == 2:
                self.mode = MODE_MERGE
                stat_mode = STAT_MERGE
            elif code == 3:
                self.mode = MODE_BIPRED
                stat_mode = STAT_BIPRED
            elif code == 4:
                self.mode = MODE_INTRA
                stat_mode = STAT_INTRA
            elif code == 4 + num_ref:
                self.mode = MODE_INTER
                self.ref_idx = 0
                stat_mode = STAT_REF_IDX0
            else:
                self.mode = MODE_INTER
                self.ref_idx = code - 4
                stat_mode = STAT_REF_IDX1 + self.ref_idx - 1
        else:
            if (bc.index == 2 or bc.index > 3) and size > MIN_BLOCK_SIZE:
                if code < 4:
                    code = (code + 1) % 4
            if split_possible and code == 1:
                fs.super_stat.append((size, STAT_SPLIT))
                return 1
            if not split_possible and code > 0:
                code += 1
            if not bipred_possible and code >= 4:
                code += 1
            if code == 0:
                self.mode = MODE_SKIP
            elif code == 2:
                self.mode = MODE_INTER
                self.ref_idx = 0
                stat_mode = STAT_REF_IDX0
            elif code == 3:
                self.mode = MODE_MERGE
                stat_mode = STAT_MERGE
            elif code == 4:
                self.mode = MODE_BIPRED
                stat_mode = STAT_BIPRED
            elif code == 5:
                self.mode = MODE_INTRA
                stat_mode = STAT_INTRA
            else:
                self.mode = MODE_INTER
                self.ref_idx = code - 5
                stat_mode = STAT_REF_IDX1 + self.ref_idx - 1
        fs.super_stat.append((size, stat_mode))
        return 0

    # --- block syntax (dec/read_bits.c:221-820) ---

    def read_block(self, size, ypos, xpos):
        seq, br, fs = self.seq, self.br, self.fs
        width, height = seq.width, seq.height
        mode = self.mode
        dd = self.dd

        rec = BlockRec(ypos=ypos, xpos=xpos, size=size,
                       bwidth=min(size, width - xpos),
                       bheight=min(size, height - ypos),
                       mode=mode, qp=self.qpb)
        coeff_block_type = (1 if mode == MODE_INTRA else 0) << 1

        mv_arr = [(0, 0)] * 4
        mv_arr0 = [(0, 0)] * 4
        mv_arr1 = [(0, 0)] * 4

        if mode in (MODE_SKIP, MODE_MERGE):
            if mode == MODE_SKIP:
                cands = get_mv_skip(ypos, xpos, width, height, size, dd)
            else:
                cands = get_mv_merge(ypos, xpos, width, height, size, dd)
            num = len(cands)
            _b0 = br.pos
            if num == 4:
                skip_idx = br.getbits(2)
            elif num == 3:
                skip_idx = 0 if br.getbits(1) else 1 + br.getbits(1)
            elif num == 2:
                skip_idx = br.getbits(1)
            else:
                skip_idx = 0
            self.bits["skip_idx"] += br.pos - _b0
            c = cands[skip_idx]
            rec.ref_idx0, rec.ref_idx1 = c.ref_idx0, c.ref_idx1
            mv_arr0 = [(c.mv0x, c.mv0y)] * 4
            mv_arr1 = [(c.mv1x, c.mv1y)] * 4
            rec.dir = c.bipred_flag

        elif mode == MODE_INTER:
            _b0 = br.pos
            if seq.pb_split:
                if br.getbits(1):
                    pb_part = 0
                elif br.getbits(1):
                    pb_part = 1
                else:
                    pb_part = 3 - br.getbits(1)
            else:
                pb_part = 0
            rec.pb_part = pb_part
            ref_idx = self.ref_idx if fs.num_ref > 1 else 0
            mvp = get_mv_pred(ypos, xpos, width, height, size, dd)
            mvp2 = mvp
            if pb_part == 0:
                mv_arr[0] = read_mv(br, mvp2)
                mv_arr = [mv_arr[0]] * 4
            elif pb_part == 1:  # HOR
                mv_arr[0] = read_mv(br, mvp2)
                mv_arr[2] = read_mv(br, mv_arr[0])
                mv_arr[1], mv_arr[3] = mv_arr[0], mv_arr[2]
            elif pb_part == 2:  # VER
                mv_arr[0] = read_mv(br, mvp2)
                mv_arr[1] = read_mv(br, mv_arr[0])
                mv_arr[2], mv_arr[3] = mv_arr[0], mv_arr[1]
            else:
                mv_arr[0] = read_mv(br, mvp2)
                mv_arr[1] = read_mv(br, mv_arr[0])
                mv_arr[2] = read_mv(br, mv_arr[0])
                mv_arr[3] = read_mv(br, mv_arr[0])
            rec.ref_idx0 = rec.ref_idx1 = ref_idx
            rec.dir = 0
            self.bits["mv"] += br.pos - _b0

        elif mode == MODE_BIPRED:
            _b0 = br.pos
            mvp = get_mv_pred(ypos, xpos, width, height, size, dd)
            mvp2 = mvp
            # BIPRED_PART=0: pb_part always 0 (dec/read_bits.c:457-459)
            mv_arr0[0] = read_mv(br, mvp2)
            mv_arr0 = [mv_arr0[0]] * 4
            if fs.stat_frame_type == B_FRAME:
                mvp2 = mv_arr0[0]
            mv_arr1[0] = read_mv(br, mvp2)
            mv_arr1 = [mv_arr1[0]] * 4
            if fs.stat_frame_type == B_FRAME:
                rec.ref_idx0, rec.ref_idx1 = 0, 1
                if fs.interp_ref_frame:
                    rec.ref_idx0 += 1
                    rec.ref_idx1 += 1
            else:
                if fs.num_ref == 2:
                    code = get_vlc0_limit(3, br)
                    rec.ref_idx0 = (code >> 1) & 1
                    rec.ref_idx1 = code & 1
                else:
                    code = get_vlc(10, br)
                    rec.ref_idx0 = (code >> 2) & 3
                    rec.ref_idx1 = code & 3
            rec.dir = 2
            self.bits["mv"] += br.pos - _b0

        elif mode == MODE_INTRA:
            _b0 = br.pos
            n = fs.num_intra_modes
            if n <= 4:
                intra_mode = br.getbits(2)
            elif n <= 8:
                inv = [3, 2, 0, 9, 8, 4, 7, 6, 1, 5]
                tmp = br.getbits(2)
                if tmp < 3:
                    code = tmp
                else:
                    tmp = br.getbits(2)
                    code = 3 + tmp if tmp < 3 else 6 + br.getbits(1)
                intra_mode = inv[code]
            else:
                inv = [3, 2, 0, 1, 9, 8, 4, 7, 6, 5]
                if br.getbits(1):
                    code = br.getbits(1)
                elif br.getbits(1):
                    code = 2 + br.getbits(1)
                elif br.getbits(1):
                    code = 4 + br.getbits(1)
                else:
                    code = 6 + br.getbits(2)
                intra_mode = inv[code]
            rec.intra_mode = intra_mode
            rec.ref_idx0 = rec.ref_idx1 = 0
            rec.dir = -1
            self.bits["intra_mode"] += br.pos - _b0

        # --- cbp + tb_split + coefficients ---
        sizeY, sizeC = size, size // 2
        tb_split = 0
        if mode != MODE_SKIP:
            _b0 = br.pos
            code = get_vlc(0, br)
            self.bits["cbp"] += br.pos - _b0
            if seq.tb_split_enable and mode in (MODE_INTRA, MODE_INTER):
                tb_split = 1 if code == 2 else 0
                if code > 2:
                    code -= 1
            rec.tb_split = tb_split

            if tb_split == 0:
                if mode == MODE_MERGE:
                    if code == 7:
                        code = 1
                    elif code > 0:
                        code = code + 1
                tmp = 0
                while tmp < 8 and code != CBP_TABLE[tmp]:
                    tmp += 1
                if mode != MODE_MERGE:
                    if self.block_context.cbp == 0 and tmp < 2:
                        tmp = 1 - tmp
                cbp_y, cbp_u, cbp_v = tmp & 1, (tmp >> 1) & 1, (tmp >> 2) & 1
                rec.cbp = (cbp_y, cbp_u, cbp_v)
                def _cc(cat, flag, sz, ct):
                    if not flag:
                        return np.zeros((sz, sz), np.int16)
                    b0 = br.pos
                    c = read_coeff(br, sz, ct)
                    self.bits[cat] += br.pos - b0
                    return c
                rec.coeff_y = _cc("coeff_y", cbp_y, sizeY,
                                  coeff_block_type | 0)
                rec.coeff_u = _cc("coeff_u", cbp_u, sizeC,
                                  coeff_block_type | 1)
                rec.coeff_v = _cc("coeff_v", cbp_v, sizeC,
                                  coeff_block_type | 1)
            else:
                # tb_split: coefficients stored as 4 quadrant sub-planes
                # packed into the full-size plane in raster order of TUs
                rec.coeff_y = np.zeros((sizeY, sizeY), np.int16)
                rec.coeff_u = np.zeros((sizeC, sizeC), np.int16)
                rec.coeff_v = np.zeros((sizeC, sizeC), np.int16)
                if size > 8:
                    for index in range(4):
                        _b0 = br.pos
                        code = get_vlc(0, br)
                        self.bits["cbp"] += br.pos - _b0
                        tmp = 0
                        while code != CBP_TABLE[tmp] and tmp < 8:
                            tmp += 1
                        if self.block_context.cbp == 0 and tmp < 2:
                            tmp = 1 - tmp
                        cy, cu, cv = tmp & 1, (tmp >> 1) & 1, (tmp >> 2) & 1
                        i, j = (index >> 1) & 1, index & 1
                        h2, c2 = sizeY // 2, sizeC // 2
                        for fl, cat, tgt, sz2, ct in (
                                (cy, "coeff_y", rec.coeff_y, h2, 0),
                                (cu, "coeff_u", rec.coeff_u, c2, 1),
                                (cv, "coeff_v", rec.coeff_v, c2, 1)):
                            if fl:
                                _c0 = br.pos
                                tgt[i*sz2:(i+1)*sz2, j*sz2:(j+1)*sz2] = \
                                    read_coeff(br, sz2,
                                               coeff_block_type | ct)
                                self.bits[cat] += br.pos - _c0
                    rec.cbp = (1, 1, 1)
                else:
                    h2 = sizeY // 2
                    for index in range(4):
                        _b0 = br.pos
                        cy = br.getbits(1)
                        self.bits["cbp"] += br.pos - _b0
                        i, j = (index >> 1) & 1, index & 1
                        if cy:
                            _c0 = br.pos
                            rec.coeff_y[i*h2:(i+1)*h2, j*h2:(j+1)*h2] = \
                                read_coeff(br, h2, coeff_block_type | 0)
                            self.bits["coeff_y"] += br.pos - _c0
                    _b0 = br.pos
                    if br.getbits(1):
                        cu = cv = 0
                    elif br.getbits(1):
                        cu, cv = 1, 0
                    elif br.getbits(1):
                        cu, cv = 0, 1
                    else:
                        cu, cv = 1, 1
                    self.bits["cbp"] += br.pos - _b0
                    if cu:
                        _c0 = br.pos
                        rec.coeff_u = read_coeff(br, sizeC,
                                                 coeff_block_type | 1)
                        self.bits["coeff_u"] += br.pos - _c0
                    if cv:
                        _c0 = br.pos
                        rec.coeff_v = read_coeff(br, sizeC,
                                                 coeff_block_type | 1)
                        self.bits["coeff_v"] += br.pos - _c0
                    rec.cbp = (1, 1, 1)
        else:
            rec.cbp = (0, 0, 0)
            rec.coeff_y = np.zeros((sizeY, sizeY), np.int16)
            rec.coeff_u = np.zeros((sizeC, sizeC), np.int16)
            rec.coeff_v = np.zeros((sizeC, sizeC), np.int16)

        if mode in (MODE_BIPRED, MODE_SKIP, MODE_MERGE):
            rec.mv_arr0 = tuple(mv_arr0)
            rec.mv_arr1 = tuple(mv_arr1)
        else:
            rec.mv_arr0 = tuple(mv_arr)
            rec.mv_arr1 = tuple(mv_arr)
        rec.tb_split = tb_split

        # store to the side-information map (dec/decode_block.c:122-156)
        pb_part_stored = rec.pb_part if mode == MODE_INTER else 0
        dd.store_block(
            ypos, xpos, rec.bwidth, rec.bheight, size, mode, rec.cbp,
            tb_split, pb_part_stored, rec.mv_arr0, rec.mv_arr1,
            rec.ref_idx0, rec.ref_idx1, rec.dir)

        self.fs.blocks.append(rec)
