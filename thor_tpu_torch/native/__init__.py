"""Native C entropy layer (thor_entropy.c), built with gcc at first use
into the package's build directory and bound with ctypes.

The serial VLC parse is the decoder's only inherently sequential host
stage; it emits the struct-of-arrays block records and per-4x4-cell side
information that the frame input builder (dec/inputs.py) consumes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..codec.constants import MAX_REF_FRAMES
from ..ops._build import GCC_FLAGS, build_shared

_SRC = Path(__file__).resolve().parent / "thor_entropy.c"

i32p = ctypes.POINTER(ctypes.c_int32)
i16p = ctypes.POINTER(ctypes.c_int16)
i64p = ctypes.POINTER(ctypes.c_int64)
u8p = ctypes.POINTER(ctypes.c_uint8)


class SeqHdrC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("width", "height", "pb_split", "tb_split_enable",
                 "max_num_ref", "interp_ref", "max_delta_qp", "deblocking",
                 "clpf", "use_block_contexts", "bipred")]


class FrameHdrC(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int32) for n in
                 ("frame_type", "stat_frame_type", "qp", "num_intra_modes",
                  "num_ref")]
                + [("ref_array", ctypes.c_int32 * 8)]
                + [(n, ctypes.c_int32) for n in
                   ("interp_ref_frame", "display_frame_num",
                    "clpf_frame_enable", "clpf_all")])


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = build_shared([("thor_entropy", ("gcc",), _SRC,
                            GCC_FLAGS)])["thor_entropy"]
        L = ctypes.CDLL(str(so))
        L.thor_parse_frame.restype = ctypes.c_int
        L.thor_parse_frame.argtypes = (
            [u8p, ctypes.c_int64, ctypes.c_int32,
             ctypes.POINTER(SeqHdrC), i32p]
            + [i32p] * 14 + [ctypes.POINTER(FrameHdrC)]
            + [i32p] * 11 + [i32p] * 4 + [i16p] * 3 + [i64p] * 3 + [i32p])
        _lib = L
    return _lib


def seqhdr_from_python(seq) -> SeqHdrC:
    """SequenceHeader -> the C struct (dec/native_adapter.py:16)."""
    s = SeqHdrC()
    for name, _t in SeqHdrC._fields_:
        setattr(s, name, getattr(seq, name))
    return s


class NativeFrame:
    """SoA result of one parsed frame."""

    __slots__ = ("hdr", "dd", "n", "ypos", "xpos", "size", "mode", "dir",
                 "ref_idx0", "ref_idx1", "intra_mode", "tb_split", "qp",
                 "cbp", "mv0x", "mv0y", "mv1x", "mv1y", "coeff_y",
                 "coeff_u", "coeff_v", "coff_y", "coff_u", "coff_v",
                 "clpf_bits")


def _i32(a):
    return a.ctypes.data_as(i32p)


def parse_frame(payload: bytes, start_bit: int, seq: SeqHdrC,
                ref_frame_nums) -> NativeFrame:
    """Entropy-decode one frame payload starting at bit `start_bit`.
    ref_frame_nums: display numbers of the sliding reference window."""
    W, H = seq.width, seq.height
    gh, gw = H // 4, W // 4
    cap_blocks = (W // 8) * (H // 8) + (W // 8) + (H // 8) + 8
    cap_y = W * H + 128 * 64 * 64
    cap_c = cap_y // 4 + 64 * 32 * 32

    dd = {k: np.zeros((gh, gw), np.int32) for k in
          ("mode", "size", "tb_split", "pb_part", "cbp_y", "cbp_u",
           "cbp_v", "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0",
           "ref_idx1", "bipred_flag")}
    fh = FrameHdrC()
    b = {k: np.zeros(cap_blocks, np.int32) for k in
         ("ypos", "xpos", "size", "mode", "dir", "ref0", "ref1", "imode",
          "tb", "qp", "cbp")}
    mv = {k: np.zeros(cap_blocks * 4, np.int32) for k in
          ("mv0x", "mv0y", "mv1x", "mv1y")}
    coeff_y = np.zeros(cap_y, np.int16)
    coeff_u = np.zeros(cap_c, np.int16)
    coeff_v = np.zeros(cap_c, np.int16)
    coff_y = np.zeros(cap_blocks, np.int64)
    coff_u = np.zeros(cap_blocks, np.int64)
    coff_v = np.zeros(cap_blocks, np.int64)
    clpf_bits = np.zeros(max((H // 64) * (W // 64), 1), np.int32)
    refnums = np.ascontiguousarray(ref_frame_nums, np.int32)
    if refnums.shape != (MAX_REF_FRAMES,):
        raise ValueError(
            f"expected {MAX_REF_FRAMES} reference frame numbers")

    n = lib().thor_parse_frame(
        ctypes.cast(payload, u8p), len(payload), start_bit,
        ctypes.byref(seq), _i32(refnums),
        _i32(dd["mode"]), _i32(dd["size"]), _i32(dd["tb_split"]),
        _i32(dd["pb_part"]), _i32(dd["cbp_y"]), _i32(dd["cbp_u"]),
        _i32(dd["cbp_v"]), _i32(dd["mv0x"]), _i32(dd["mv0y"]),
        _i32(dd["mv1x"]), _i32(dd["mv1y"]), _i32(dd["ref_idx0"]),
        _i32(dd["ref_idx1"]), _i32(dd["bipred_flag"]),
        ctypes.byref(fh),
        _i32(b["ypos"]), _i32(b["xpos"]), _i32(b["size"]), _i32(b["mode"]),
        _i32(b["dir"]), _i32(b["ref0"]), _i32(b["ref1"]), _i32(b["imode"]),
        _i32(b["tb"]), _i32(b["qp"]), _i32(b["cbp"]),
        _i32(mv["mv0x"]), _i32(mv["mv0y"]), _i32(mv["mv1x"]),
        _i32(mv["mv1y"]),
        coeff_y.ctypes.data_as(i16p), coeff_u.ctypes.data_as(i16p),
        coeff_v.ctypes.data_as(i16p),
        coff_y.ctypes.data_as(i64p), coff_u.ctypes.data_as(i64p),
        coff_v.ctypes.data_as(i64p),
        _i32(clpf_bits))
    if n < 0:
        raise ValueError("native parse failed")

    nf = NativeFrame()
    nf.hdr = fh
    nf.dd = dd
    nf.n = n
    for k in ("ypos", "xpos", "size", "mode", "dir", "qp", "cbp"):
        setattr(nf, k, b[k][:n])
    nf.ref_idx0 = b["ref0"][:n]
    nf.ref_idx1 = b["ref1"][:n]
    nf.intra_mode = b["imode"][:n]
    nf.tb_split = b["tb"][:n]
    for k in ("mv0x", "mv0y", "mv1x", "mv1y"):
        setattr(nf, k, mv[k][:n * 4].reshape(n, 4))
    nf.coeff_y, nf.coeff_u, nf.coeff_v = coeff_y, coeff_u, coeff_v
    nf.coff_y, nf.coff_u, nf.coff_v = coff_y[:n], coff_u[:n], coff_v[:n]
    nf.clpf_bits = clpf_bits
    return nf
