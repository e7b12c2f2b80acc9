"""The encoder's intra scan: the CUDA kernel's wrapper
(csrc/enc_intra_scan.cu) and its plain PyTorch version.

Counterpart of thor_tpu/ops/pallas_enc_intra.py (kernel 6 of the port)
and of the XLA scan enc/device_intra._encode_scan_fn. The scan is the
encoder's final pass over the transform units (TUs) the search chose, in
coding order: predict from already reconstructed neighbours, transform
and quantize the residual against the original, reconstruct exactly as
the decoder will, and put out the quantized coefficients. The plain
version walks coding order; the kernel runs a TU as soon as the earlier
TUs that wrote its context samples are done (ops/intra.intra_levels gives
the depth of that dependency graph). Records are
those of the decoder's scan (ops/intra.py: ty, tx, size, mode, toplen,
leftlen, cbx_nonzero; build_intra_records), one row per TU, row i of the
coefficient output being TU i. The device encoder's fused final program
(enc/fused.py) pads them to a bucket and passes the real count on the
device, as the decoder's scan takes it (ops/intra.py): the padded records
never run and their rows of the coefficient output stay zero.

Every plane is quantized with the luma rule (chroma=False in
quantize_fwd_batch), as the JAX scans do; only the search tells chroma
apart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..codec.constants import GDEQUANT_TABLE, GQUANT_TABLE, zigzag_for
from ..device import check_current
from . import _build
from . import kernels as K
from .intra import NF, PADE, PADI, _predict, tu_context

I32 = torch.int32


def encode_scan_plain(planes, org, recs, qp: int, fast: bool, intra: bool,
                      count=None):
    """Sequential encode + exact reconstruction over TU records.

    planes/org: [C, H, W] int32 (C = 1 luma, sizes 8..64; C = 2 for U+V,
    sizes 4..32, sharing TU geometry); recs: [N, 7] int32; qp: the QP of
    this plane class; fast: box-summed transforms above 16x16; intra: the
    quantizer's offset set; count: as encode_scan's. Returns (planes
    [C, H, W] int32, q16 [N, C, 16, 16] int16: the low-frequency levels of
    every TU, zero for a padded record)."""
    encode_scan_plain.calls += 1
    C, H, W = planes.shape
    dev = planes.device
    P = F.pad(planes.to(I32), (PADI, PADE, PADI, PADE))
    O = org.to(I32)
    q16 = torch.zeros((recs.shape[0], C, 16, 16), dtype=torch.int16,
                      device=dev)
    recs = K.real_records(recs, count)
    zzs = {qs: torch.as_tensor(zigzag_for(qs), dtype=torch.long, device=dev)
           for qs in (4, 8, 16)}
    for t, rec in enumerate(recs.tolist()):
        ty, tx, s, mode = rec[:4]
        y, x = PADI + ty, PADI + tx
        left, top, tl = tu_context(P, rec)
        pred = _predict(left, top, tl, ty, tx, s, mode)
        coeff = K.fwd_transform_batch(O[:, ty:ty + s, tx:tx + s] - pred, s,
                                      fast)
        qs = min(s, 16)
        q, _ = K.quantize_fwd_batch(coeff, qp, s, intra, zzs[qs])
        P[:, y:y + s, x:x + s] = K.recon_from_q(pred, q, s, qp)
        q16[t, :, :qs, :qs] = q[:, :qs, :qs].to(torch.int16)
    return P[:, PADI:PADI + H, PADI:PADI + W].contiguous(), q16


encode_scan_plain.calls = 0


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        L = _build.cuda_library("enc_intra_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.thor_enc_intra_scan_count.restype = ci
        L.thor_enc_intra_scan_count.argtypes = [
            vp, vp, vp, ci, ci, ci, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
            ci, vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _lib = L
    return _lib


def scan_scratch(H: int, W: int, dev):
    """The kernel's scratch for planes of H x W: the unit ticket and the
    owner map of the 4x4 cells (one int32 each). The kernel initialises
    it itself, on the stream."""
    return torch.empty(1 + ((H + 3) // 4) * ((W + 3) // 4), dtype=I32,
                       device=dev)


def encode_scan(planes, org, recs, qp: int, fast: bool, intra: bool,
                count=None):
    """Encoder intra scan of C planes sharing one TU record set; see
    encode_scan_plain for the arguments and the result. count: None (all
    N records are real) or a [1] int32 tensor on the planes' device, the
    number of real records at the head of recs (the rest pad a bucket and
    never run). A CPU tensor takes the plain version; a CUDA tensor
    launches csrc/enc_intra_scan.cu (which writes a copy of `planes` and
    reads `planes`, left as it was, wherever no earlier TU wrote). The
    records come from ops/intra.build_intra_records: TUs inside the plane,
    4-aligned, not overlapping."""
    if planes.device.type == "cpu":
        return encode_scan_plain(planes, org, recs, qp, fast, intra, count)
    if planes.device.type != "cuda":
        raise ValueError(f"encode_scan: unsupported device {planes.device}")
    check_current("encode_scan", planes.device)
    K.check_count("encode_scan", count, planes.device)
    if planes.dim() != 3 or org.shape != planes.shape:
        raise ValueError("encode_scan: planes and org must be [C, H, W]")
    for name, t in (("planes", planes), ("org", org), ("recs", recs)):
        if t.device != planes.device or t.dtype != I32 \
                or not t.is_contiguous():
            raise ValueError(f"encode_scan: {name} must be a contiguous "
                             f"int32 tensor on {planes.device}")
    if recs.dim() != 2 or recs.shape[1] != NF:
        raise ValueError(f"encode_scan: recs must be [N, {NF}]")
    if not 0 <= qp <= 51:
        raise ValueError(f"encode_scan: qp {qp} outside 0..51")
    C, H, W = planes.shape
    n = recs.shape[0]
    out = planes.clone()
    q16 = (torch.empty if count is None else torch.zeros)(
        (n, C, 16, 16), dtype=torch.int16, device=planes.device)
    if n:
        L = _kernel()
        gdq = int(GDEQUANT_TABLE[qp % 6])
        scratch = scan_scratch(H, W, planes.device)
        err = L.thor_enc_intra_scan_count(
            planes.data_ptr(), out.data_ptr(), org.data_ptr(), C, H, W,
            recs.data_ptr(), n, None if count is None else count.data_ptr(),
            scratch.data_ptr(), q16.data_ptr(),
            int(GQUANT_TABLE[qp % 6]), qp // 6,
            gdq << (qp // 6), 73 * gdq, int(bool(fast)), int(bool(intra)),
            torch.cuda.current_stream(planes.device).cuda_stream)
        if err:
            raise RuntimeError("encode_scan launch failed: "
                               + L.thor_cuda_error_string(err).decode())
        encode_scan.launches += 1
    return out, q16


encode_scan.launches = 0
