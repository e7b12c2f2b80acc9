"""The configuration's settings are the published configuration's: its
frame structure is that of the stream the reference encoder wrote with
it at 1080p, and its encoder settings make the port's host mirror of the
reference's RD search rewrite the reference's CIF stream of it."""

from __future__ import annotations

import hashlib
import json

import numpy as np

from benchmark.reference.decode import stream_headers
from benchmark.tests.rehearsal import BENCH, REPO
from benchmark.traffic.encode_live import HEADER_KEYS, encoder_fields

CONFIG = json.loads((BENCH / "configs" / "ldb_1080.json").read_text())
TESTDATA = REPO / "testdata"


def test_sequence_is_the_published_streams():
    seq, frames = stream_headers(TESTDATA / "LDB_medium_complexity_1080.bit")
    assert frames == CONFIG["sequence"]
    assert len(frames) == CONFIG["frames"]
    for field, key in HEADER_KEYS:
        assert getattr(seq, field) == CONFIG[key], field


def test_settings_rewrite_the_published_cif_stream(tmp_path):
    """The first 4 frames of test_cif.yuv under the configuration's
    settings give the digest testdata/conformance_cif.sha256 holds for
    config_LDB_medium_complexity.txt (the reference encoder's)."""
    from thor_tpu_torch.enc.encoder import Encoder, EncoderParams
    digest = next(line.split()[0] for line in (
        TESTDATA / "conformance_cif.sha256").read_text().splitlines()
        if line.split()[2] == "LDB_medium_complexity")
    W, H, n = 352, 288, 4
    raw = np.fromfile(TESTDATA / "test_cif.yuv", np.uint8)
    size = W * H * 3 // 2
    frames = []
    for k in range(n):
        f = raw[k * size:(k + 1) * size]
        frames.append((f[:W * H].reshape(H, W),
                       f[W * H:W * H * 5 // 4].reshape(H // 2, W // 2),
                       f[W * H * 5 // 4:].reshape(H // 2, W // 2)))
    fields = dict(encoder_fields(CONFIG), width=W, height=H,
                  device_encode=0)
    out = tmp_path / "ldb.bit"
    Encoder(EncoderParams.in_code(num_frames=n, **fields),
            device="cpu").encode_sequence(frames, str(out))
    assert hashlib.sha256(out.read_bytes()).hexdigest() == digest
