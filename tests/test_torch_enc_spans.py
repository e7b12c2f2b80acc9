"""The encoder's spans and its wait counter on the CPU: a small LDB and RA
encode on the fused path under utils/tracing.device_trace, its profiler
events held to Encoder.frame_times. One enc.frame.<I|P|B> span a frame;
each stage span and enc.upload inside its frame's span, each child span
inside its stage's; a stage span lasts at least its frame_times value;
"waits" is 2 on the I frame and on a P/B frame without a second chance,
3 with one."""

import pytest
import torch

from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.utils import tracing as T

from tools.gen_torch_enc_goldens import load_frames

# the stage spans of a frame, by kind, and their frame_times keys
STAGES = {"I": ("search", "scan", "emit", "filters"),
          "P": ("measure", "decide", "second_chance", "final", "emit",
                "filters")}
STAGES["B"] = STAGES["P"]
# the child spans of a stage span
CHILDREN = {
    "enc.measure": ("enc.measure.pack", "enc.measure.program",
                    "enc.measure.fetch"),
    "enc.second_chance": ("enc.second_chance.collect",
                          "enc.second_chance.program",
                          "enc.second_chance.fetch",
                          "enc.second_chance.splice",
                          "enc.second_chance.walk"),
    "enc.final": ("enc.final_inputs", "enc.final.program",
                  "enc.final.fetch"),
    "enc.search": ("enc.search.program", "enc.search.fetch",
                   "enc.search.walk"),
    "enc.scan": ("enc.scan.inputs", "enc.scan.program", "enc.scan.fetch"),
}
# a stage span against its frame_times value (s): the clock reads sit
# inside the profiler's range
TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced_encode(name, tmp_path):
    """(frame_times, [(name, start_s, end_s)] of the enc.* spans)."""
    fields, frames = load_frames(name)
    enc = E1.Encoder(E1.EncoderParams(**fields), device="cpu")
    with T.device_trace(None, "cpu") as prof:
        enc.encode_sequence(frames, str(tmp_path / "o.bit"))
    spans = [(e.name(), e.start_ns() / 1e9,
              (e.start_ns() + e.duration_ns()) / 1e9)
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("enc.")]
    return enc.frame_times, spans


def _inside(spans, lo, hi, name):
    return [s for s in spans if s[0] == name and lo <= s[1] and s[2] <= hi]


@pytest.mark.parametrize("name,second_chance", [("ldb_qcif", True),
                                                ("ra_qcif", False)])
def test_encoder_spans_nest_and_count_waits(name, second_chance, tmp_path):
    """ldb_qcif's P frames each have a second chance, ra_qcif's B and P
    frames none (its speed skips it)."""
    frame_times, spans = _traced_encode(name, tmp_path)
    frames = sorted((s for s in spans if s[0].startswith("enc.frame.")),
                    key=lambda s: s[1])
    assert len(frames) == len(frame_times)
    assert frames[0][0] == "enc.frame.I"
    assert all(f[0] in ("enc.frame.P", "enc.frame.B") for f in frames[1:])
    for (fname, lo, hi), ft in zip(frames, frame_times):
        kind = fname[-1]
        assert len(_inside(spans, lo, hi, "enc.upload")) == 1
        for key in STAGES[kind]:
            stage = _inside(spans, lo, hi, "enc." + key)
            assert len(stage) == 1, (fname, key)
            _, a, b = stage[0]
            assert b - a >= ft[key] - TOL, (fname, key)
            for child in CHILDREN.get("enc." + key, ()):
                n = len(_inside(spans, a, b, child))
                # the second chance's children only where it ran
                assert n == 1 or (n == 0 and key == "second_chance"), \
                    (fname, child)
            if key == "final":
                assert b - a >= ft["final_inputs"] - TOL
        had = bool(_inside(spans, lo, hi, "enc.second_chance.program"))
        if kind == "I":
            assert ft["waits"] == 2
        else:
            assert had == second_chance
            assert ft["waits"] == (3 if had else 2), fname
    # every child span lies inside a stage span of its own name
    for stage, children in CHILDREN.items():
        for child in children:
            for _, a, b in (s for s in spans if s[0] == child):
                assert any(s[0] == stage and s[1] <= a and b <= s[2]
                           for s in spans), child
