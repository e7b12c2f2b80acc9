"""The synthetic frame of thor_tpu_torch.utils.synth against thor_tpu's
(thor_tpu/utils/synth.py): the same seed gives the same frame once the
port's layout is read back (the sparse residual groups densified, the MC
records expanded to the 4x4 MV / slot fields), and the port's frame
program on it equals thor_tpu's _frame_fn, jitted on the CPU as
tests/test_parallel.py runs it. Tolerance: equal integers."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from thor_tpu.dec.reconstruct_jax import _frame_fn
from thor_tpu.utils.synth import build_synthetic_frame as synth0

from thor_tpu_torch.codec.constants import PAD_C, PAD_Y
from thor_tpu_torch.dec.reconstruct import mc_luts, reconstruct_frame
from thor_tpu_torch.ops import kernels as K
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.utils.synth import build_synthetic_frame as synth1

SIZES = [(128, 64), (192, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(recs, H, W, pad, fb, tap_lo, cell):
    """MC records -> the [H/cell, W/cell] (mvx, mvy, slot) fields of list
    0 (floor semantics: mv = (ipos - pos - pad - tap_lo) << fb | phase)."""
    r = recs.numpy().astype(np.int64)
    fm = (1 << fb) - 1
    out = [np.full((H // cell, W // cell), -999, np.int64) for _ in range(3)]
    for y0, x0, h, w, sl, ph, iy, ix in r[:, :8]:
        mvx = ((ix - x0 - pad - tap_lo) << fb) | (ph & fm)
        mvy = ((iy - y0 - pad - tap_lo) << fb) | (ph >> fb)
        reg = (slice(y0 // cell, (y0 + h) // cell),
               slice(x0 // cell, (x0 + w) // cell))
        for a, v in zip(out, (mvx, mvy, sl)):
            a[reg] = v
    return out


@pytest.mark.parametrize("W,H", SIZES)
def test_synthetic_inputs_equal_thor_tpus(W, H):
    cfg0, inp0 = synth0(W, H, R=2, seed=5)
    cfg, inp, refs = synth1(W, H, R=2, seed=5, device="cpu")
    assert (cfg.W, cfg.H, cfg.R, cfg.deblocking, cfg.clpf) == \
        (cfg0.W, cfg0.H, cfg0.R, cfg0.deblocking, cfg0.clpf)
    assert not cfg0.has_bi and cfg0.bipred_filter == 0
    for c, k in (("y", "refY"), ("u", "refU"), ("v", "refV")):
        assert np.array_equal(
            np.stack([getattr(r, c).numpy() for r in refs]), inp0[k])
    # the MV field: luma cells of 4, chroma cells of 2 at half the plane
    mvx, mvy, slot = _fields(inp["mc_y"], H, W, PAD_Y, 2, -2, 4)
    assert np.array_equal(mvx, inp0["mv0x"])
    assert np.array_equal(mvy, inp0["mv0y"])
    assert np.array_equal(slot, inp0["slot0"])
    cx, cy, cs = _fields(inp["mc_c"], H // 2, W // 2, PAD_C, 3, -1, 2)
    assert np.array_equal(cx, mvx) and np.array_equal(cy, mvy) \
        and np.array_equal(cs, slot)
    assert not inp0["use_bi"].any()
    # the residual groups, densified
    for k in ("gy16", "gy8", "gy4", "gc8", "gc4"):
        g0 = inp0[k]
        n, s = g0["coeff"].shape[:2]
        if not n:
            assert k not in inp
            continue
        g = inp[k]
        assert np.array_equal(K.densify(g["cidx"], g["cval"], n, s).numpy(),
                              g0["coeff"])
        for f in ("y", "x", "f", "a", "sh") + (("pl",) if "pl" in g0
                                               else ()):
            assert np.array_equal(g[f].numpy(), g0[f]), (k, f)
    assert "it_y" not in inp and not inp0["tuy"]["valid"].any()
    assert np.array_equal(inp["ddp"].numpy(), np.asarray(inp0["ddp"]))
    for k in ("beta", "tc", "tcC"):
        assert inp[k] == int(inp0[k])
    for k in ("m8y", "m8u", "m8v"):
        assert np.array_equal(inp[k].numpy(), inp0[k])


def test_synthetic_frame_program_equals_thor_tpus():
    """The port's frame program (kernel 2's plain version here) and
    thor_tpu's _frame_fn on the same synthetic frame: equal planes. A
    1080-line frame's last 16-row band is cut to 8 rows: 192x136 has the
    same cut (136 = 8 * 16 + 8)."""
    W, H = 192, 136
    cfg0, inp0 = synth0(W, H, R=2, seed=11)
    cpu = jax.devices("cpu")[0]
    want = jax.jit(partial(_frame_fn, cfg0))(jax.device_put(inp0, cpu))
    cfg, inp, refs = synth1(W, H, R=2, seed=11, device="cpu")
    n0, l0 = MC.mc_frame_plain.calls, MC.mc_frame.launches
    planes, padded = reconstruct_frame(cfg, inp, refs,
                                       mc_luts(0, torch.device("cpu")))
    assert MC.mc_frame_plain.calls == n0 + 2 and MC.mc_frame.launches == l0
    for got, w in zip(planes, want):
        assert np.array_equal(got.numpy(), np.asarray(w))
    assert padded[0].shape == (H + 2 * PAD_Y, W + 2 * PAD_Y)


def test_synthetic_frame_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth1(64, 64)
