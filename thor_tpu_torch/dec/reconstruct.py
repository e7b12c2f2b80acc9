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

import torch

from ..codec.constants import PAD_C, PAD_Y
from ..ops import kernels as K
from ..ops.intra import intra_scan
from ..ops.mc import mc_frame

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


def reconstruct_frame(cfg, inp, refs, luts):
    """Decode one frame from its device inputs.

    refs: the R reference objects (codec-padded .y/.u/.v uint8 tensors)
    in slot order; luts: mc_luts(). Returns (y, u, v) uint8 planes and
    their edge-padded copies (pad 96 luma, 48 chroma) for the reference
    window."""
    H, W = cfg.H, cfg.W
    dev = luts[0].device
    ry, rc = residual_planes(cfg, inp, dev)
    y, uv = predict_planes(cfg, inp, refs, luts, ry, rc)
    if "it_y" in inp:
        y = intra_scan(y[None].contiguous(), ry[None], inp["it_y"])[0]
        uv = intra_scan(uv.contiguous(), rc, inp["it_c"])
    u, v = uv[0], uv[1]
    if cfg.deblocking:
        dd = K.unpack_ddp(inp["ddp"])
        y = K.deblock_luma(y, dd, H, W, inp["beta"], inp["tc"])
        u = K.deblock_chroma(u, dd, H, W, inp["tcC"])
        v = K.deblock_chroma(v, dd, H, W, inp["tcC"])
    if cfg.clpf:
        y = K.clpf_plane(y, inp["m8y"], 64, H, W)
        u = K.clpf_plane(u, inp["m8u"], 32, H // 2, W // 2)
        v = K.clpf_plane(v, inp["m8v"], 32, H // 2, W // 2)
    y, u, v = (p.to(torch.uint8) for p in (y, u, v))
    return (y, u, v), (K.edge_pad(y, PAD_Y), K.edge_pad(u, PAD_C),
                       K.edge_pad(v, PAD_C))
