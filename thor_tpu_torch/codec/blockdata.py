"""Frame-wide side-information map ("deblock data") and neighbor derivation.

The reference keeps a per-4x4-cell array of structs
(deblock_data_t, common/types.h:127-135) used for MV prediction, skip and
merge candidate derivation, deblocking decisions, and block contexts.
Here it is a struct-of-arrays over the (H/4, W/4) grid so the in-loop
filters can consume it directly as device tensors. Counterpart of
thor_tpu/codec/blockdata.py.

Derivation functions mirror common/inter_prediction.c:182-600 and
common/common_block.c:100-178 exactly (required for bit-exact parsing:
the entropy decode of skip/merge indices depends on the derived
candidate count).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import MIN_PB_SIZE


@dataclass(frozen=True)
class InterPred:
    """Mirror of inter_pred_t (common/types.h:111-118)."""
    mv0x: int = 0
    mv0y: int = 0
    mv1x: int = 0
    mv1y: int = 0
    ref_idx0: int = 0
    ref_idx1: int = 0
    bipred_flag: int = 0

    def key(self):
        return (self.mv0x, self.mv0y, self.ref_idx0,
                self.mv1x, self.mv1y, self.ref_idx1)


ZERO_PRED = InterPred()


class DeblockData:
    """SoA over the 4x4 grid; ints are plain numpy int32 planes."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        gh, gw = height // MIN_PB_SIZE, width // MIN_PB_SIZE
        self.gh, self.gw = gh, gw
        z = lambda: np.zeros((gh, gw), dtype=np.int32)
        self.mode = z()
        self.size = z()
        self.tb_split = z()
        self.pb_part = z()
        self.cbp_y = z()
        self.cbp_u = z()
        self.cbp_v = z()
        self.mv0x = z()
        self.mv0y = z()
        self.mv1x = z()
        self.mv1y = z()
        self.ref_idx0 = z()
        self.ref_idx1 = z()
        self.bipred_flag = z()

    def reset(self):
        for a in (self.mode, self.size, self.tb_split, self.pb_part,
                  self.cbp_y, self.cbp_u, self.cbp_v, self.mv0x, self.mv0y,
                  self.mv1x, self.mv1y, self.ref_idx0, self.ref_idx1,
                  self.bipred_flag):
            a.fill(0)

    def inter_pred_at(self, flat_index: int) -> InterPred:
        r, c = divmod(flat_index, self.gw)
        return InterPred(
            int(self.mv0x[r, c]), int(self.mv0y[r, c]),
            int(self.mv1x[r, c]), int(self.mv1y[r, c]),
            int(self.ref_idx0[r, c]), int(self.ref_idx1[r, c]),
            int(self.bipred_flag[r, c]))

    def store_block(self, ypos, xpos, bwidth, bheight, size, mode, cbp,
                    tb_split, pb_part, mv_arr0, mv_arr1, ref_idx0, ref_idx1,
                    dir_flag):
        """Mirror of copy_deblock_data (dec/decode_block.c:122-156).

        mv_arr0/mv_arr1: 4 (x, y) pairs indexed by PB quadrant.
        """
        by, bx = ypos // MIN_PB_SIZE, xpos // MIN_PB_SIZE
        div = size // (2 * MIN_PB_SIZE)
        for m in range(bheight // MIN_PB_SIZE):
            for n in range(bwidth // MIN_PB_SIZE):
                m0 = m // div if div > 0 else 0
                n0 = n // div if div > 0 else 0
                index = 2 * m0 + n0
                r, c = by + m, bx + n
                self.cbp_y[r, c] = cbp[0]
                self.cbp_u[r, c] = cbp[1]
                self.cbp_v[r, c] = cbp[2]
                self.tb_split[r, c] = 1 if tb_split > 0 else 0
                self.pb_part[r, c] = pb_part
                self.size[r, c] = size
                self.mode[r, c] = mode
                self.mv0x[r, c] = mv_arr0[index][0]
                self.mv0y[r, c] = mv_arr0[index][1]
                self.ref_idx0[r, c] = ref_idx0
                self.mv1x[r, c] = mv_arr1[index][0]
                self.mv1y[r, c] = mv_arr1[index][1]
                self.ref_idx1[r, c] = ref_idx1
                self.bipred_flag[r, c] = dir_flag


# --- Availability (common/common_block.c:100-129) ---

def get_upright_available(ypos, xpos, size, width):
    avail = (ypos > 0) and (xpos + size < width)
    if size == 32 and (ypos % 64) == 32:
        avail = False
    if size == 16 and ((ypos % 32) == 16 or ((ypos % 64) == 32 and (xpos % 32) == 16)):
        avail = False
    if size == 8 and ((ypos % 16) == 8 or ((ypos % 32) == 16 and (xpos % 16) == 8)
                      or ((ypos % 64) == 32 and (xpos % 32) == 24)):
        avail = False
    return avail


def get_downleft_available(ypos, xpos, size, height):
    avail = (xpos > 0) and (ypos + size < height)
    if size == 64:
        avail = False
    if size == 32 and (ypos % 64) == 32:
        avail = False
    if size == 16 and ((ypos % 64) == 48 or ((ypos % 64) == 16 and (xpos % 32) == 16)):
        avail = False
    if size == 8 and ((ypos % 64) == 56 or ((ypos % 16) == 8 and (xpos % 16) == 8)
                      or ((ypos % 64) == 24 and (xpos % 32) == 16)):
        avail = False
    return avail


# --- Block context (common/common_block.c:158-178) ---

@dataclass
class BlockContext:
    split: int = -1
    cbp: int = -1
    index: int = -1


def find_block_contexts(ypos, xpos, height, width, size, dd: DeblockData,
                        enable: bool) -> BlockContext:
    MIN_BS = 8  # MIN_BLOCK_SIZE
    if (ypos >= MIN_BS and xpos >= MIN_BS and ypos + size < height
            and xpos + size < width and enable and size <= 64):
        by, bx = ypos // MIN_PB_SIZE, xpos // MIN_PB_SIZE
        up, left = (by - 1, bx), (by, bx - 1)
        split = int(dd.size[up] < size) + int(dd.size[left] < size)
        cbp1 = int(dd.cbp_y[up] > 0) + int(dd.cbp_y[left] > 0)
        cbp2 = (int(dd.cbp_y[up] > 0 or dd.cbp_u[up] > 0 or dd.cbp_v[up] > 0)
                + int(dd.cbp_y[left] > 0 or dd.cbp_u[left] > 0 or dd.cbp_v[left] > 0))
        return BlockContext(split=split, cbp=cbp1, index=3 * split + cbp2)
    return BlockContext()


# --- MV prediction (common/inter_prediction.c:182-294) ---

def get_mv_pred(ypos, xpos, width, height, size, dd: DeblockData):
    block_size = size // MIN_PB_SIZE
    block_stride = width // MIN_PB_SIZE
    bi = (ypos // MIN_PB_SIZE) * block_stride + (xpos // MIN_PB_SIZE)

    up0 = bi - block_stride
    up1 = bi - block_stride + (block_size - 1) // 2
    up2 = bi - block_stride + block_size - 1
    left0 = bi - 1
    left1 = bi + block_stride * ((block_size - 1) // 2) - 1
    left2 = bi + block_stride * (block_size - 1) - 1
    downleft = bi + block_stride * block_size - 1
    upright = bi - block_stride + block_size
    upleft = bi - block_stride - 1

    U = ypos > 0
    L = xpos > 0
    UR = get_upright_available(ypos, xpos, size, width)
    DL = get_downleft_available(ypos, xpos, size, height)

    g = dd.inter_pred_at
    if not U and not UR and not L and not DL:
        a = b = c = ZERO_PRED
    elif U and not UR and not L and not DL:
        a, b, c = g(up0), g(up1), g(up2)
    elif U and UR and not L and not DL:
        a, b, c = g(up0), g(up2), g(upright)
    elif not U and not UR and L and not DL:
        a, b, c = g(left0), g(left1), g(left2)
    elif U and not UR and L and not DL:
        a, b, c = g(upleft), g(up2), g(left2)
    elif U and UR and L and not DL:
        a, b, c = g(up0), g(upright), g(left2)
    elif not U and not UR and L and DL:
        a, b, c = g(left0), g(left2), g(downleft)
    elif U and not UR and L and DL:
        a, b, c = g(up2), g(left0), g(downleft)
    elif U and UR and L and DL:
        a, b, c = g(up0), g(upright), g(left0)
    else:
        raise AssertionError("impossible availability pattern")

    def median(p, q, r):
        if p < q:
            return min(q, max(p, r))
        return min(p, max(q, r))

    return (median(a.mv0x, b.mv0x, c.mv0x), median(a.mv0y, b.mv0y, c.mv0y))


def _two_candidates(ypos, xpos, width, height, size, dd: DeblockData):
    """Shared LIMITED_SKIP candidate selection for skip & merge
    (common/inter_prediction.c:331-348, 484-501)."""
    block_size = size // MIN_PB_SIZE
    block_stride = width // MIN_PB_SIZE
    bi = (ypos // MIN_PB_SIZE) * block_stride + (xpos // MIN_PB_SIZE)

    up0 = bi - block_stride
    up2 = bi - block_stride + block_size - 1
    left0 = bi - 1
    left2 = bi + block_stride * (block_size - 1) - 1
    upright = bi - block_stride + block_size

    up_available = ypos > 0
    left_available = xpos > 0
    upright_available = get_upright_available(ypos, xpos, size, width)

    # Rectangular skip blocks at frame boundaries
    if ypos + size > height:
        left2 = left0
    if xpos + size > width:
        up2 = up0

    c0 = dd.inter_pred_at(left2) if left_available else ZERO_PRED
    if upright_available:
        c1 = dd.inter_pred_at(upright)
    elif up_available:
        c1 = dd.inter_pred_at(up2)
    else:
        c1 = ZERO_PRED
    return [c0, c1]


def _dedup(cands):
    """common/inter_prediction.c:428-446 / 581-598."""
    out = [cands[0]]
    for c in cands[1:]:
        dup = any(
            c.key() == o.key() and (c.bipred_flag == o.bipred_flag or c.bipred_flag == -1)
            for o in out)
        if not dup:
            out.append(c)
    return out


def get_mv_skip(ypos, xpos, width, height, size, dd: DeblockData):
    return _dedup(_two_candidates(ypos, xpos, width, height, size, dd))


def get_mv_merge(ypos, xpos, width, height, size, dd: DeblockData):
    return _dedup(_two_candidates(ypos, xpos, width, height, size, dd))
