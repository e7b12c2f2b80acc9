"""Seeded test clips for the encode cells.

A copy of the recipe of testdata/gen_input_1080.py (smooth gradients, a
texture, two travelling waves, a moving flat block, chroma waves), made
on the device in a few large operations. The seed draws the texture, the
waves' phase and the block's start and velocity; every seed gives the
same sizes and the same kinds of content. Frames are (y, u, v) uint8
numpy planes, as the encoder takes them. The encode cells draw their
clips from a fixed bank (bank_clip): clip k of it is drawn from k.
"""

from __future__ import annotations

import hashlib

import numpy as np

BLOCK = 144


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one piece of a run, from the run's seed and tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_clip(seed: int, width: int, height: int, frames: int, device):
    """`frames` (y, u, v) frames of a width x height clip drawn from
    `seed`, generated on `device`."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "clip"))
    W, H = width, height
    r = torch.rand(4, generator=g, device=device).tolist()
    tex = torch.randint(0, 25, (H, W), generator=g, device=device,
                        dtype=torch.int32).float()
    t0 = 100.0 * r[0]
    span = frames - 1
    # the block's path stays inside the frame for the whole clip
    vx = 8 + int(16 * r[1]) if W >= BLOCK + 24 * span else 0
    vy = 4 + int(12 * r[2]) if H >= BLOCK + 16 * span else 0
    bx0 = int(r[3] * max(W - BLOCK - vx * span, 1))
    by0 = int(r[0] * max(H - BLOCK - vy * span, 1))
    f32 = torch.float32
    xs = torch.arange(W, device=device, dtype=f32)[None, :]
    ys = torch.arange(H, device=device, dtype=f32)[:, None]
    base = torch.remainder(xs + ys, 256.0)
    xc = torch.arange(W // 2, device=device, dtype=f32)[None, :]
    yc = torch.arange(H // 2, device=device, dtype=f32)[:, None]
    t = (t0 + torch.arange(frames, device=device, dtype=f32))[:, None, None]
    y = (0.5 * base + tex + 40 * torch.sin(xs / 53.0 + t * 0.3)
         + 30 * torch.cos(ys / 37.0 - t * 0.2) + 60)
    for k in range(frames):
        bx, by = bx0 + vx * k, by0 + vy * k
        y[k, by:by + BLOCK, bx:bx + BLOCK] = 200 - 3 * (k % 64)
    u = 128 + 30 * torch.sin(xc / 49.0 + t * 0.1) + torch.remainder(yc, 32)
    v = 128 - 20 * torch.cos(xc / 79.0 - t * 0.15) + tex[::2, ::2] * 0.5
    planes = [p.clamp(0, 255).to(torch.uint8).cpu().numpy()
              for p in (y, u, v)]
    return [tuple(np.ascontiguousarray(p[k]) for p in planes)
            for k in range(frames)]


def bank_clip(k: int, width: int, height: int, frames: int, device):
    """Clip k of the fixed bank the encode cells draw from."""
    return make_clip(sub_seed(k, "bank"), width, height, frames, device)
