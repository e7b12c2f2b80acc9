"""Native C layers, built with gcc at first use into the package's build
directory and bound with ctypes.

thor_entropy.c: the serial VLC parse, the decoder's only inherently
sequential host stage; it emits the struct-of-arrays block records and
per-4x4-cell side information that the frame input builder (dec/inputs.py)
consumes.

thor_decide.c: the device encoder's decision walk over the measured cost
maps of a P/B frame and the emission of the decided frame's syntax.

thor_interp.c: the temporal interpolation pyramid on the host, the numpy
decode backend's interpolated reference (ops/temporal_interp.py).

All three are copies of thor_tpu's sources (thor_tpu/native/), kept as
they are. Each builds into its own library; a failed build raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..codec.constants import MAX_REF_FRAMES, PAD_C, PAD_Y
from ..ops._build import GCC_FLAGS, build_shared

_SRC = Path(__file__).resolve().parent / "thor_entropy.c"
_SRC_DECIDE = Path(__file__).resolve().parent / "thor_decide.c"
_SRC_INTERP = Path(__file__).resolve().parent / "thor_interp.c"

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


class SizeMeasC(ctypes.Structure):
    """The measured maps of one block size (thor_decide.c SizeMeas)."""
    _fields_ = [("mvx", i32p), ("mvy", i32p), ("slot", i32p),
                ("ssd_coded", i64p), ("ssd_pred", i64p), ("bits", i32p),
                ("cbp_y", u8p), ("cbp_u", u8p), ("cbp_v", u8p),
                ("intra_cost", i64p), ("intra_mode", i32p),
                ("mvx1", i32p), ("mvy1", i32p), ("slot1", i32p),
                ("ssd_tb", i64p), ("bits_tb", i32p),
                ("cbp_tb_y", u8p), ("cbp_tb_u", u8p), ("cbp_tb_v", u8p),
                ("K", ctypes.c_int32), ("N", ctypes.c_int32),
                ("HB", ctypes.c_int32), ("WB", ctypes.c_int32),
                ("K_uni", ctypes.c_int32), ("has_tb", ctypes.c_int32)]


class LeafC(ctypes.Structure):
    """One decided leaf (thor_decide.c LeafOut)."""
    _fields_ = [(n, ctypes.c_int32) for n in
                ("ypos", "xpos", "size", "mode", "mvx", "mvy", "ref",
                 "skip_idx", "intra_mode", "use_cbp", "k", "idx",
                 "mv1x", "mv1y", "ref1", "dir", "tb")]


class BankC(ctypes.Structure):
    _fields_ = [("qy", i16p), ("qu", i16p), ("qv", i16p),
                ("ydim", ctypes.c_int32), ("cdim", ctypes.c_int32)]


class EmitParamsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("W", "H", "num_ref", "enable_bipred", "interp_ref",
                 "use_block_contexts", "num_intra_modes",
                 "max_num_tb_part", "max_num_pb_part",
                 "max_delta_qp", "frame_type")] \
        + [("bitbuf", ctypes.c_uint32), ("bitrest", ctypes.c_int32)]


class DDOutC(ctypes.Structure):
    _fields_ = [(n, i32p) for n in
                ("mode", "size", "tb_split", "pb_part", "cbp_y",
                 "cbp_u", "cbp_v", "mv0x", "mv0y", "mv1x", "mv1y",
                 "ref_idx0", "ref_idx1", "bipred_flag")]


_decide_lib = None


def decide_lib() -> ctypes.CDLL:
    global _decide_lib
    if _decide_lib is None:
        so = build_shared([("thor_decide", ("gcc",), _SRC_DECIDE,
                            GCC_FLAGS)])["thor_decide"]
        L = ctypes.CDLL(str(so))
        ci, dbl = ctypes.c_int, ctypes.c_double
        L.thor_decide_frame.restype = ci
        L.thor_decide_frame.argtypes = [
            ci, ci, ci, ci, ci, ci, ci, dbl, dbl,
            ctypes.POINTER(SizeMeasC), ctypes.POINTER(LeafC)]
        L.thor_emit_frame.restype = ctypes.c_long
        L.thor_emit_frame.argtypes = [
            ctypes.POINTER(EmitParamsC), ctypes.POINTER(LeafC), ci, i32p,
            i32p, ctypes.POINTER(BankC), ctypes.POINTER(DDOutC), u8p,
            ctypes.c_long]
        _decide_lib = L
    return _decide_lib


def decide_frame_native(W, H, num_ref, enable_bipred, interp_ref,
                        use_block_contexts, frame_type, lam, lam_me,
                        per_size):
    """Run the C decision walk (thor_decide_frame) and return its LeafC
    records in coding order.

    per_size: 4 dicts (sizes 8, 16, 32, 64) of [K, N] arrays mvx / mvy /
    slot / mvx1 / mvy1 / slot1, ssd_coded / ssd_pred, bits, cbp_y / u / v,
    optionally the tb maps ssd_tb / bits_tb / cbp_tb_y / u / v, the
    [HB, WB] intra_cost / intra_mode maps and K_uni (variants from it on
    are bipred pairs). lam and lam_me are C doubles. Raises when the
    leaves do not tile the frame."""
    meas = (SizeMeasC * 4)()
    keep = []
    for m, d, s in zip(meas, per_size, (8, 16, 32, 64)):
        K, N = np.asarray(d["mvx"]).shape
        HB, WB = H // s, W // s
        if N != HB * WB or np.shape(d["intra_cost"]) != (HB, WB):
            raise ValueError(f"decide_frame_native: size {s} maps have "
                             f"the wrong shape")

        def arr(key, dt, ptr):
            a = np.ascontiguousarray(d[key], dt)
            keep.append(a)
            return a.ctypes.data_as(ptr)

        for key in ("mvx", "mvy", "slot", "mvx1", "mvy1", "slot1", "bits",
                    "intra_mode"):
            setattr(m, key, arr(key, np.int32, i32p))
        for key in ("ssd_coded", "ssd_pred", "intra_cost"):
            setattr(m, key, arr(key, np.int64, i64p))
        for key in ("cbp_y", "cbp_u", "cbp_v"):
            setattr(m, key, arr(key, np.uint8, u8p))
        m.K, m.N, m.HB, m.WB, m.K_uni = K, N, HB, WB, int(d["K_uni"])
        if "ssd_tb" in d:
            m.ssd_tb = arr("ssd_tb", np.int64, i64p)
            m.bits_tb = arr("bits_tb", np.int32, i32p)
            for key in ("cbp_tb_y", "cbp_tb_u", "cbp_tb_v"):
                setattr(m, key, arr(key, np.uint8, u8p))
            m.has_tb = 1
    maxl = (W // 8) * (H // 8 + 8)
    leaves = (LeafC * maxl)()
    n = decide_lib().thor_decide_frame(
        W, H, num_ref, enable_bipred, interp_ref, use_block_contexts,
        frame_type, float(lam), float(lam_me), meas, leaves)
    out = leaves[:n]
    if not 0 < n <= maxl or sum(lf.size ** 2 for lf in out) != W * H:
        raise RuntimeError(f"thor_decide_frame: {n} leaves do not tile the "
                           f"{W}x{H} frame")
    return out


def emit_frame_native(w, enc_params, leaves, bank_row, cbp3, banks, dd):
    """Emit the decided frame's superblock payload through the C writers
    (thor_emit_frame) into the BitWriter `w`, and fill the DeblockData
    `dd` as store_deblock_data would.

    leaves: records with the LeafC fields (mv, mv1 as (x, y) pairs);
    bank_row / cbp3: per leaf, its row of its bank and its cbp bits;
    banks: 5 dicts (sizes 8 / 16 / 32 / 64 coded, then intra) of int16
    qy / qu / qv level arrays with their ydim / cdim."""
    n = len(leaves)
    leaf_arr = (LeafC * max(n, 1))()
    for i, lf in enumerate(leaves):
        leaf_arr[i] = LeafC(
            lf.ypos, lf.xpos, lf.size, lf.mode, lf.mv[0], lf.mv[1], lf.ref,
            lf.skip_idx, lf.intra_mode, 1 if lf.use_cbp else 0, lf.k,
            lf.idx, lf.mv1[0], lf.mv1[1], lf.ref1, lf.dir, lf.tb)
    keep = []

    def i16(a, dim):
        a = np.ascontiguousarray(a, np.int16)
        if a.size == 0:
            a = np.zeros((1, dim, dim), np.int16)
        if a.shape[1:] != (dim, dim):
            raise ValueError(f"emit_frame_native: bank of {a.shape[1:]} "
                             f"where {dim}x{dim} was expected")
        keep.append(a)
        return a.ctypes.data_as(i16p)

    bank_arr = (BankC * 5)()
    for i, b in enumerate(banks):
        ydim, cdim = b["ydim"], b["cdim"]
        bank_arr[i] = BankC(i16(b["qy"], ydim), i16(b["qu"], cdim),
                            i16(b["qv"], cdim), ydim, cdim)
    p = EmitParamsC(*[int(enc_params[k]) for k in
                      ("W", "H", "num_ref", "enable_bipred", "interp_ref",
                       "use_block_contexts", "num_intra_modes",
                       "max_num_tb_part", "max_num_pb_part", "max_delta_qp",
                       "frame_type")],
                    ctypes.c_uint32(w.bitbuf).value, w.bitrest)
    names = [name for name, _ in DDOutC._fields_]
    planes = [getattr(dd, name) for name in names]
    for name, a in zip(names, planes):
        if a.dtype != np.int32 or not a.flags.c_contiguous \
                or a.shape != (enc_params["H"] // 4, enc_params["W"] // 4):
            raise ValueError(f"emit_frame_native: dd.{name} must be a "
                             f"C-contiguous int32 [H/4, W/4] plane")
    ddo = DDOutC(*[a.ctypes.data_as(i32p) for a in planes])
    cap = enc_params["W"] * enc_params["H"] + (1 << 16)
    out = np.empty(cap, np.uint8)
    br = np.ascontiguousarray(bank_row, np.int32)
    c3 = np.ascontiguousarray(cbp3, np.int32)
    if br.shape != (n,) or c3.shape != (n,):
        raise ValueError("emit_frame_native: one bank row and one cbp per "
                         "leaf")
    nb = decide_lib().thor_emit_frame(
        ctypes.byref(p), leaf_arr, n, _i32(br), _i32(c3), bank_arr,
        ctypes.byref(ddo), out.ctypes.data_as(u8p), cap)
    if not 0 <= nb <= cap:
        raise RuntimeError(f"thor_emit_frame returned {nb}")
    w.buf += out[:nb].tobytes()
    w.bitbuf = int(p.bitbuf)
    w.bitrest = int(p.bitrest)


_interp_lib = None


def interp_lib() -> ctypes.CDLL:
    global _interp_lib
    if _interp_lib is None:
        so = build_shared([("thor_interp", ("gcc",), _SRC_INTERP,
                            GCC_FLAGS)])["thor_interp"]
        L = ctypes.CDLL(str(so))
        ci = ctypes.c_int
        L.thor_interpolate_frames.restype = None
        L.thor_interpolate_frames.argtypes = [u8p] * 6 + [ci] * 4 + [u8p] * 3
        _interp_lib = L
    return _interp_lib


def interpolate_frames_native(ref0, ref1, ratio: int, pos: int):
    """The C twin of ops/temporal_interp.interpolate_frames: ref0 / ref1
    carry codec-padded uint8 numpy planes .y (pad 96) and .u / .v (pad
    48); returns the synthesized frame's unpadded (y, u, v)."""
    h = ref0.y.shape[0] - 2 * PAD_Y
    w = ref0.y.shape[1] - 2 * PAD_Y
    shapes = ((h + 2 * PAD_Y, w + 2 * PAD_Y),
              (h // 2 + 2 * PAD_C, w // 2 + 2 * PAD_C),
              (h // 2 + 2 * PAD_C, w // 2 + 2 * PAD_C))
    planes = []
    for r in (ref0, ref1):
        for a, shape in zip((r.y, r.u, r.v), shapes):
            a = np.ascontiguousarray(a, np.uint8)
            if a.shape != shape:
                raise ValueError(f"interpolate_frames_native: plane of shape "
                                 f"{a.shape} where {shape} was expected")
            planes.append(a)
    out = [np.empty((h, w), np.uint8), np.empty((h // 2, w // 2), np.uint8),
           np.empty((h // 2, w // 2), np.uint8)]
    interp_lib().thor_interpolate_frames(
        *(a.ctypes.data_as(u8p) for a in planes), w, h, int(ratio),
        int(pos), *(a.ctypes.data_as(u8p) for a in out))
    return tuple(out)


def seqhdr_from_python(seq) -> SeqHdrC:
    """SequenceHeader -> the C struct (dec/native_adapter.py:16)."""
    s = SeqHdrC()
    for name, _t in SeqHdrC._fields_:
        setattr(s, name, getattr(seq, name))
    return s


# the per-4x4-cell side-information planes of a parsed frame (NativeFrame.dd,
# the fields of codec/blockdata.DeblockData), in thor_parse_frame's order
DD_KEYS = ("mode", "size", "tb_split", "pb_part", "cbp_y", "cbp_u", "cbp_v",
           "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0", "ref_idx1",
           "bipred_flag")


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

    dd = {k: np.zeros((gh, gw), np.int32) for k in DD_KEYS}
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
