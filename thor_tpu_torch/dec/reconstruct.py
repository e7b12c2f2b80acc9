"""The frame program: one function per frame on tensors.

Port of thor_tpu dec/reconstruct_jax.py:590-714 (the `_jit_fused` body).
Stages, in order: sparse coefficient densify; dequant + inverse DCT per
transform size, then scatter; block MC (CUDA kernel 1); the intra scan in
decode order (CUDA kernel 2); deblocking, then CLPF; codec-padded
reference planes as output. PyTorch runs eagerly, so there is no compile
step: on the card every stage is queued on the current stream and the
host does not wait.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import PAD_C, PAD_Y
from ..ops import kernels as K
from ..ops.intra import intra_scan
from ..ops.mc import R_H, R_Y0, mc_frame

I32 = torch.int32


def to_device(inp, device):
    """numpy input dict -> tensors on `device` (python ints stay)."""
    out = {}
    for k, v in inp.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
        elif hasattr(v, "dtype"):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = v
    return out


def mc_luts(bipred_filter: int, device):
    """[P, T*T] int32 LUTs for luma and chroma."""
    ly = K.build_luma_mc_lut(bipred_filter)
    lc = K.build_chroma_mc_lut()
    return (torch.from_numpy(ly.reshape(16, 36)).to(device),
            torch.from_numpy(lc.reshape(64, 16)).to(device))


def residual_planes(cfg, inp, device):
    """Dequantized inverse-transformed residual: ([H, W], [2, H/2, W/2])
    int32."""
    H, W = cfg.H, cfg.W
    ry = torch.zeros((H, W), dtype=I32, device=device)
    rc = torch.zeros((2, H // 2, W // 2), dtype=I32, device=device)
    for s in (4, 8, 16, 32, 64):
        g = inp.get(f"gy{s}")
        if g is None:
            continue
        cs = 32 if s == 64 else s
        coeff = K.densify(g["cidx"], g["cval"], len(g["y"]), cs)
        vals = K.residual_group(coeff, g["f"], g["a"], g["sh"], cs)
        if s == 64:       # 64x64: 32-point iDCT of the low quadrant, 2x2
            vals = vals.repeat_interleave(2, 1).repeat_interleave(2, 2)
        ry = K.scatter_tu(ry, vals, g["y"], g["x"])
    for s in (4, 8, 16, 32):
        g = inp.get(f"gc{s}")
        if g is None:
            continue
        coeff = K.densify(g["cidx"], g["cval"], len(g["y"]), s)
        vals = K.residual_group(coeff, g["f"], g["a"], g["sh"], s)
        rc = K.scatter_tu_c(rc, vals, g["y"], g["x"], g["pl"])
    return ry, rc


def predict_planes(cfg, inp, refs, luts, ry, rc):
    """Inter prediction plus residual, clipped: ([H, W], [2, H/2, W/2])
    int32; zeros on an intra frame (the intra scan fills every pixel)."""
    H, W = cfg.H, cfg.W
    if cfg.R == 0:
        return torch.zeros_like(ry), torch.zeros_like(rc)
    refY = torch.stack([r.y for r in refs])[None]
    refUV = torch.stack([torch.stack([r.u for r in refs]),
                         torch.stack([r.v for r in refs])])
    py = mc_frame(refY, inp["mc_y"], luts[0], H, W)[0]
    puv = mc_frame(refUV, inp["mc_c"], luts[1], H // 2, W // 2)
    return K.clip255(py + ry), K.clip255(puv + rc)


def intra_planes(inp, y, uv, ry, rc):
    """The intra scan in decode order (kernel 1) over the whole frame's
    predicted planes, where the frame has intra TUs."""
    if "it_y" in inp:
        y = intra_scan(y[None].contiguous(), ry[None], inp["it_y"])[0]
        uv = intra_scan(uv.contiguous(), rc, inp["it_c"])
    return y, uv


def filter_rows(cfg, inp, y, u, v, r0: int = 0):
    """Deblocking, then CLPF, of the luma rows [r0, r0 + h) of the
    unfiltered int32 planes (y [h, W], u / v the chroma rows [r0/2,
    (r0 + h)/2)); the frame's side-info maps are sliced to match. On the
    whole frame r0 is 0. On a slice, r0 is a multiple of 64 and every
    position test of the ops stays aligned, so the slice's rows equal the
    frame's except within reach of the slice's own first and last rows
    (the deblocking's rolls and frame-edge terms), which a caller keeps
    64 rows away from the rows it uses."""
    h, W = y.shape
    if cfg.deblocking:
        dd = K.unpack_ddp(inp["ddp"][r0 // 4:(r0 + h) // 4])
        y = K.deblock_luma(y, dd, h, W, inp["beta"], inp["tc"])
        u = K.deblock_chroma(u, dd, h, W, inp["tcC"])
        v = K.deblock_chroma(v, dd, h, W, inp["tcC"])
    if cfg.clpf:
        m = slice(r0 // 8, (r0 + h) // 8)
        y = K.clpf_plane(y, inp["m8y"][m], 64, h, W)
        u = K.clpf_plane(u, inp["m8u"][m], 32, h // 2, W // 2)
        v = K.clpf_plane(v, inp["m8v"][m], 32, h // 2, W // 2)
    return y, u, v


def finish_planes(y, u, v):
    """uint8 planes and their edge-padded copies (pad 96 luma, 48
    chroma) for the reference window."""
    y, u, v = (p.to(torch.uint8) for p in (y, u, v))
    return (y, u, v), (K.edge_pad(y, PAD_Y), K.edge_pad(u, PAD_C),
                       K.edge_pad(v, PAD_C))


def reconstruct_frame(cfg, inp, refs, luts):
    """Decode one frame from its device inputs.

    refs: the R reference objects (codec-padded .y/.u/.v uint8 tensors)
    in slot order; luts: mc_luts(). Returns (y, u, v) uint8 planes and
    their edge-padded copies (pad 96 luma, 48 chroma) for the reference
    window."""
    ry, rc = residual_planes(cfg, inp, luts[0].device)
    y, uv = predict_planes(cfg, inp, refs, luts, ry, rc)
    y, uv = intra_planes(inp, y, uv, ry, rc)
    return finish_planes(*filter_rows(cfg, inp, y, uv[0], uv[1]))


# ---------------------------------------------------------------------------
# Row bands (parallel/mesh.py splits a frame across the 'tile' axis)
# ---------------------------------------------------------------------------

BAND = 64       # band edges fall on whole superblock rows


def band_rows(H: int, n: int):
    """[(r0, r1)] luma rows of n bands: edges on multiples of 64, the
    superblock rows shared as evenly as they go; a band may be empty."""
    nsb = -(-H // BAND)
    edges = [min(H, BAND * (nsb * k // n)) for k in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def _rows_in(y, h, r0, r1, band, what):
    """Mask of the rectangles (origin y, height h) in rows [r0, r1);
    raises if a rectangle crosses a band-sized row line."""
    if len(y) and ((y // band) != ((y + h - 1) // band)).any():
        raise ValueError(f"{what}: a rectangle crosses a {band}-row line")
    return (y >= r0) & (y < r1)


def _band_group(g, sel, r0, cs):
    """One residual TU group restricted to the TUs `sel` (a bool mask),
    their rows moved up by r0; the sparse coefficients keep their TUs."""
    keep = np.nonzero(sel)[0]
    out = {k: v[keep] for k, v in g.items() if k not in ("cidx", "cval")}
    out["y"] = out["y"] - r0
    tu = g["cidx"] // (cs * cs)
    m = sel[tu]
    new = np.full(len(sel), -1, np.int64)
    new[keep] = np.arange(len(keep))
    out["cidx"] = new[tu[m]] * (cs * cs) + g["cidx"][m] % (cs * cs)
    out["cval"] = g["cval"][m]
    return out


def band_inputs(inp, r0: int, r1: int):
    """The host inputs of luma rows [r0, r1) for the residual and block
    MC stages: TU groups and MC records whose rows lie in the band, moved
    up by r0 (chroma by r0 / 2). r0 is a multiple of 64; no TU and no MC
    record crosses a 64-row (chroma: 32-row) line, since PUs and TUs lie
    inside superblocks."""
    out = {}
    for k, g in inp.items():
        if k.startswith(("gy", "gc")):
            s = int(k[2:])
            c = k.startswith("gc")
            a, b, band = (r0 // 2, r1 // 2, BAND // 2) if c else \
                (r0, r1, BAND)
            sel = _rows_in(g["y"], s, a, b, band, k)
            if sel.any():
                out[k] = _band_group(g, sel, a, 32 if s == 64 else s)
    for k, c in (("mc_y", 1), ("mc_c", 2)):
        if k in inp:
            rec = inp[k]
            sel = _rows_in(rec[:, R_Y0], rec[:, R_H], r0 // c, r1 // c,
                           BAND // c, k)
            rec = rec[sel].copy()
            rec[:, R_Y0] -= r0 // c
            out[k] = rec
    return out
