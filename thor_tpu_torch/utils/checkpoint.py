"""Decoder state carried across from thor_tpu.

A codec has no weights: its state is the reference window. thor_tpu's
`save_decoder_state` (utils/checkpoint.py:16) writes an .npz holding
`ref{i}_y/u/v/num`, `seq` and the optional `interp_*`; this loader reads
that file into the port's Decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import PAD_C, PAD_Y
from ..dec.decoder import RefFrame
from ..dec.parse import SequenceHeader
from ..ops.kernels import edge_pad


def _plane(a, h, w, pad, device):
    """Saved plane -> codec-padded uint8 tensor on `device`; accepts the
    plane either padded (as thor_tpu's numpy decoder keeps it) or not."""
    a = np.asarray(a, np.uint8)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if a.shape == (h, w):
        return edge_pad(t, pad)
    if a.shape != (h + 2 * pad, w + 2 * pad):
        raise ValueError(f"reference plane of shape {a.shape} does not "
                         f"fit a {w}x{h} sequence")
    return t


def _ref(z, key, seq, device):
    H, W = seq.height, seq.width
    return RefFrame(_plane(z[f"{key}_y"], H, W, PAD_Y, device),
                    _plane(z[f"{key}_u"], H // 2, W // 2, PAD_C, device),
                    _plane(z[f"{key}_v"], H // 2, W // 2, PAD_C, device),
                    int(z[f"{key}_num"]))


def load_decoder_state(dec, path: str):
    """Restore `dec` (a thor_tpu_torch Decoder) from a thor_tpu decoder
    snapshot. Decoding continues with `dec.decode_payloads` on the
    remaining frame payloads. The snapshot holds no output position, so
    the next frame to output is taken as the first display number missing
    from the saved window, counting up from its oldest frame; window frames
    past it were decoded ahead of their turn (RA / HDB) and go to
    `dec.pending`. Exact while the reorder depth stays below the window's
    33 frames."""
    with np.load(path) as z:
        dec.start(SequenceHeader(*(int(x) for x in z["seq"])))
        refs = list(dec.refs)
        loaded = []
        for i in range(len(refs)):
            if f"ref{i}_y" in z:
                refs[i] = _ref(z, f"ref{i}", dec.seq, dec.device)
                loaded.append(refs[i])
        dec.refs = refs
        if "interp_y" in z:
            dec.interp_frame = _ref(z, "interp", dec.seq, dec.device)
    have = {r.frame_num: r for r in reversed(loaded)}     # newest wins
    n = min(have)
    while n in have:
        n += 1
    dec.next_display = n
    dec.pending = [r for num, r in have.items() if num > n]
    return dec
