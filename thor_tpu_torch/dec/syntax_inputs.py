"""A FrameSyntax (the Python parser's frame) laid out as the native C
parse lays out its frame, so that the frame input builder
(dec/inputs.build_frame_inputs) and the frame program take frames of
either parser unchanged. The port's counterpart of thor_tpu's
`reconstruct_jax.build_frame_inputs(fs, ...)` (dec/reconstruct_jax.py:214).

Layout contract with thor_entropy.c (thor_parse_frame): the block records
in decode order; each block reserves a size*size raster slab of luma
coefficients and two (size/2)^2 chroma slabs, back to back (a tb-split
block's quadrants fill the spatial quadrants of its slab, a non-split
64x64 block codes only its top-left 32x32); `cbp` packs (y, u, v) as
bits 0-2; `clpf_bits` holds one entry per full 64x64 superblock
(width // 64 by height // 64, raster order, -1 where no bit was read),
and one 0 where the frame has no full superblock.
"""

from __future__ import annotations

import numpy as np

from ..codec.constants import MAX_BLOCK_SIZE
from ..native import DD_KEYS, FrameHdrC, NativeFrame


def frame_header(fs) -> FrameHdrC:
    """The frame header fields of `fs` in the C parse's struct."""
    fh = FrameHdrC()
    for name in ("frame_type", "stat_frame_type", "qp", "num_intra_modes",
                 "num_ref", "display_frame_num", "clpf_frame_enable",
                 "clpf_all"):
        setattr(fh, name, int(getattr(fs, name)))
    fh.interp_ref_frame = int(bool(fs.interp_ref_frame))
    for i, r in enumerate(fs.ref_array):
        fh.ref_array[i] = r
    return fh


def syntax_to_native(fs, seq) -> NativeFrame:
    """FrameSyntax -> NativeFrame (the fields dec/inputs.py reads)."""
    W, H = seq.width, seq.height
    blocks = fs.blocks
    n = len(blocks)
    nf = NativeFrame()
    nf.hdr = frame_header(fs)
    nf.dd = {k: np.ascontiguousarray(getattr(fs.deblock_data, k), np.int32)
             for k in DD_KEYS}
    nf.n = n

    def col(get):
        return np.fromiter((get(b) for b in blocks), np.int32, n)

    nf.ypos = col(lambda b: b.ypos)
    nf.xpos = col(lambda b: b.xpos)
    nf.size = col(lambda b: b.size)
    nf.mode = col(lambda b: b.mode)
    nf.dir = col(lambda b: b.dir)
    nf.ref_idx0 = col(lambda b: b.ref_idx0)
    nf.ref_idx1 = col(lambda b: b.ref_idx1)
    nf.intra_mode = col(lambda b: b.intra_mode)
    nf.tb_split = col(lambda b: b.tb_split)
    nf.qp = col(lambda b: b.qp)
    nf.cbp = col(lambda b: b.cbp[0] | (b.cbp[1] << 1) | (b.cbp[2] << 2))
    mv = np.array([(b.mv_arr0, b.mv_arr1) for b in blocks],
                  np.int32).reshape(n, 2, 4, 2)
    nf.mv0x, nf.mv0y = mv[:, 0, :, 0].copy(), mv[:, 0, :, 1].copy()
    nf.mv1x, nf.mv1y = mv[:, 1, :, 0].copy(), mv[:, 1, :, 1].copy()

    sq = nf.size.astype(np.int64) ** 2
    nf.coff_y = np.concatenate([[0], np.cumsum(sq)[:-1]]).astype(np.int64)
    nf.coff_u = nf.coff_y // 4
    nf.coff_v = nf.coff_u.copy()
    for k in ("y", "u", "v"):
        planes = [getattr(b, f"coeff_{k}").ravel() for b in blocks]
        setattr(nf, f"coeff_{k}",
                np.concatenate(planes).astype(np.int16) if planes
                else np.zeros(0, np.int16))

    nfb = (H // MAX_BLOCK_SIZE) * (W // MAX_BLOCK_SIZE)
    clpf = np.full(max(nfb, 1), -1 if nfb else 0, np.int32)
    if fs.clpf_bits is not None:
        clpf[:nfb] = np.asarray(fs.clpf_bits).ravel()
    nf.clpf_bits = clpf
    return nf
