"""Per-block windows of a reference plane at per-block offsets.

Counterpart of thor_tpu/ops/windowed.py, ported by what it outputs: block
(t, k) of a grid with stride `bstep` gets the w x w window whose top-left
sample is (base_y + t*bstep + dy[t, k], base_x + k*bstep + dx[t, k]), the
offsets bounded by |d| <= M. Samples below or right of the plane read 0,
as the TPU form's zero-padded strips do; above or left of it there is
nothing to read (the bases keep every window inside).

The TPU builds these windows from rolls and selects (a gather there costs
nanoseconds per element); on the GPU one indexed load per window sample
is the direct form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def banded_windows_stack(planes, slot, dy, dx, base_y: int, base_x: int,
                         bstep: int, w: int, M: int):
    """[HB, WB, w, w] windows of a [R, Hp, Wp] plane stack; block (t, k)
    reads plane slot[t, k] (a slot outside [0, R) reads plane 0, as the
    TPU form's selects leave it). dy, dx, slot: [HB, WB] integer tensors.
    Same dtype as `planes`."""
    if base_y - M < 0 or base_x - M < 0:
        raise ValueError("window support above or left of the plane")
    R, Hp, Wp = planes.shape
    HB, WB = dy.shape
    dev = planes.device
    ph = max(0, base_y + (HB - 1) * bstep + M + w - Hp)
    pw = max(0, base_x + (WB - 1) * bstep + M + w - Wp)
    if ph or pw:
        planes = F.pad(planes, (0, pw, 0, ph))
    Hp, Wp = Hp + ph, Wp + pw
    slot = slot.long()
    slot = torch.where((slot >= 0) & (slot < R), slot, 0)
    oy = base_y + bstep * torch.arange(HB, device=dev)[:, None] + dy.long()
    ox = base_x + bstep * torch.arange(WB, device=dev)[None, :] + dx.long()
    ar = torch.arange(w, device=dev)
    rows = (slot * Hp + oy)[:, :, None, None] + ar[:, None]
    idx = rows * Wp + (ox[:, :, None, None] + ar[None, :])
    return planes.reshape(-1)[idx]


def banded_windows(plane, dy, dx, base_y: int, base_x: int, bstep: int,
                   w: int, M: int):
    """banded_windows_stack of one [Hp, Wp] plane."""
    return banded_windows_stack(plane[None], torch.zeros_like(dy), dy, dx,
                                base_y, base_x, bstep, w, M)
