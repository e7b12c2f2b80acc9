"""Codec state carried across runs, and across from thor_tpu.

A codec has no weights: its state is the reference window. The decoder's
snapshot (save_decoder_state / load_decoder_state, thor_tpu's
utils/checkpoint.py:16 / :85) is an .npz holding the codec-padded uint8
planes `ref{i}_y/u/v` with their display numbers `ref{i}_num`, the
sequence header `seq` (11 int64) and the optional interpolated reference
`interp_*`. The encoder's snapshot (save_encoder_state /
load_encoder_state, thor_tpu's :42 / :66) holds the same reference planes
and the sequence loop's eight counters `loop` (int64). Each file is the
same in both packages, so a snapshot of either resumes in the other, on
either of the port's decode backends.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import PAD_C, PAD_Y
from ..dec.decoder import RefFrame
from ..dec.parse import SequenceHeader
from ..dec.reconstruct_np import RefFrame as NpRefFrame

SEQ_FIELDS = ("width", "height", "pb_split", "tb_split_enable",
              "max_num_ref", "interp_ref", "max_delta_qp", "deblocking",
              "clpf", "use_block_contexts", "bipred")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_decoder_state(dec, path: str):
    """Snapshot a Decoder (either backend) after any number of frames: its
    reference window and interpolated reference (padded planes, read back
    from the device on the torch backend) and its sequence header."""
    arrs = {}
    for i, r in enumerate(dec.refs):
        if r is None:
            continue
        arrs[f"ref{i}_y"], arrs[f"ref{i}_u"], arrs[f"ref{i}_v"] = \
            _host(r.y), _host(r.u), _host(r.v)
        arrs[f"ref{i}_num"] = np.int64(r.frame_num)
    r = dec.interp_frame
    if r is not None:
        arrs["interp_y"], arrs["interp_u"], arrs["interp_v"] = \
            _host(r.y), _host(r.u), _host(r.v)
        arrs["interp_num"] = np.int64(r.frame_num)
    arrs["seq"] = np.array([getattr(dec.seq, f) for f in SEQ_FIELDS],
                           np.int64)
    np.savez_compressed(path, **arrs)


def _padded(a, h, w, pad):
    """Saved plane -> codec-padded uint8 array; accepts the plane either
    padded (as both packages save it) or not."""
    a = np.asarray(a, np.uint8)
    if a.shape == (h, w):
        return np.pad(a, pad, mode="edge")
    if a.shape != (h + 2 * pad, w + 2 * pad):
        raise ValueError(f"reference plane of shape {a.shape} does not "
                         f"fit a {w}x{h} sequence")
    return np.ascontiguousarray(a)


def _ref(z, key, seq, dec):
    H, W = seq.height, seq.width
    planes = (_padded(z[f"{key}_y"], H, W, PAD_Y),
              _padded(z[f"{key}_u"], H // 2, W // 2, PAD_C),
              _padded(z[f"{key}_v"], H // 2, W // 2, PAD_C))
    num = int(z[f"{key}_num"])
    if dec.backend == "numpy":
        r = NpRefFrame.__new__(NpRefFrame)      # the planes are padded
        r.y, r.u, r.v = planes
        r.frame_num = num
        return r
    return RefFrame(*(torch.from_numpy(p).to(dec.device) for p in planes),
                    num)


def load_decoder_state(dec, path: str):
    """Restore `dec` (a thor_tpu_torch Decoder, either backend) from a
    decoder snapshot of either package. Decoding continues with
    `dec.decode_payloads` on the remaining frame payloads. The snapshot
    holds no output position, so the next frame to output is taken as the
    first display number missing from the saved window, counting up from
    its oldest frame; window frames past it were decoded ahead of their
    turn (RA / HDB) and go to `dec.pending`. Exact while the reorder depth
    stays below the window's 33 frames."""
    with np.load(path) as z:
        dec.start(SequenceHeader(*(int(x) for x in z["seq"])))
        refs = list(dec.refs)
        loaded = []
        for i in range(len(refs)):
            if f"ref{i}_y" in z:
                refs[i] = _ref(z, f"ref{i}", dec.seq, dec)
                loaded.append(refs[i])
        dec.refs = refs
        if "interp_y" in z:
            dec.interp_frame = _ref(z, "interp", dec.seq, dec)
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
