"""Codec state carried across runs, and across from thor_tpu.

A codec has no weights: its state is the reference window. thor_tpu's
`save_decoder_state` (utils/checkpoint.py:16) writes an .npz holding
`ref{i}_y/u/v/num`, `seq` and the optional `interp_*`; load_decoder_state
reads that file into the port's Decoder. The encoder's snapshot
(save_encoder_state / load_encoder_state, thor_tpu's :42 / :66) holds
the padded uint8 planes `ref{i}_y/u/v`, `ref{i}_num` and the sequence
loop's eight counters `loop` (int64): the same file in both packages, so
a snapshot of either resumes in the other.
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


LOOP_KEYS = ("frame_num0", "num_encoded", "last_PorI",
             "last_intra_frame_num", "sub_gop", "num_reorder_pics",
             "HQperiod", "stream_bytes")


def save_encoder_state(enc, path: str, loop: dict):
    """Snapshot an Encoder at a sub-GOP boundary (between frames): its
    reference window (codec-padded planes, read back from the device or
    taken from the mirror's host copies) and the sequence-loop counters
    `loop` (LOOP_KEYS). Together these are the whole inter-frame state:
    resuming from them reproduces the rest of the stream byte for byte."""
    arrs = {}
    for i, r in enumerate(enc.refs):
        if r is None:
            continue
        h = r.host()
        arrs[f"ref{i}_y"], arrs[f"ref{i}_u"], arrs[f"ref{i}_v"] = \
            h.y, h.u, h.v
        arrs[f"ref{i}_num"] = np.int64(r.frame_num)
    arrs["loop"] = np.array([loop[k] for k in LOOP_KEYS], np.int64)
    np.savez_compressed(path, **arrs)


def load_encoder_state(enc, path: str) -> dict:
    """Restore an Encoder's reference window on its device (the numpy
    planes stay as the mirror's host copies); returns the loop counters
    to continue encode_sequence from."""
    from ..enc.encoder import RefFrame     # enc.encoder imports this module
    from ..enc.host import HostRef

    refs = [None] * len(enc.refs)
    with np.load(path) as z:
        for i in range(len(refs)):
            if f"ref{i}_y" not in z:
                continue
            planes = [np.ascontiguousarray(z[f"ref{i}_{c}"], np.uint8)
                      for c in "yuv"]
            num = int(z[f"ref{i}_num"])
            refs[i] = RefFrame.of_padded(
                *(torch.from_numpy(a).to(enc.device) for a in planes), num,
                host=HostRef(*planes, num))
        lo = z["loop"]
    enc.refs = refs
    return {k: int(v) for k, v in zip(LOOP_KEYS, lo)}
