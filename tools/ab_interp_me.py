#!/usr/bin/env python3
"""A/B of two builds of the pyramid-ME kernel on one CUDA card.

    python3 tools/ab_interp_me.py other_interp_me.cu

Builds thor_tpu_torch/csrc/interp_me.cu ("tree") and the given source
("other", for instance an earlier commit's file written out with
`git show REV:thor_tpu_torch/csrc/interp_me.cu`), both with the C entry
thor_interp_me_level of the tree's signature. Runs both on the same
inputs, in the order other, tree, tree, other, at every pyramid level of
two 1080p frame pairs: seeded correlated noise frames and the first
interpolated frame of testdata/RA16_high_efficiency_1080.bit. Prints the
device ms of each run (CUDA events around a CUDA-graph replay) and
whether the two outputs are equal to each other and to the main path's.
The scratch map is zeroed before every launch of either build. Run from
the repo's root; needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S                                    # noqa: E402
from thor_tpu_torch.ops import _build                     # noqa: E402
from thor_tpu_torch.ops import interp as TI               # noqa: E402


def load(other: Path):
    jobs = [(name, (_build.nvcc(),), src, _build.NVCC_FLAGS)
            for name, src in (("other", other),
                              ("tree", _build.CSRC / "interp_me.cu"))]
    libs = {}
    for name, path in _build.build_shared(jobs).items():
        L = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.thor_interp_me_level.restype = ci
        L.thor_interp_me_level.argtypes = [vp, vp] + [ci] * 6 + [vp] * 6
        libs[name] = L
    return libs


def main(argv):
    if len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_interp_me needs a CUDA device")
    libs = load(Path(argv[1]))
    dev = torch.device("cuda")
    w, h = 1920, 1080
    levels = TI.num_levels(w, h)
    r1, r2, ratio, pos = S.first_interp_pair(dev)
    for label, a, b, (ratio, pos) in (
            ("seeded", *S.correlated_frames(8, w, h, (2, 3), dev), (2, 1)),
            ("stream", r1, r2, (ratio, pos))):
        rev, wt0, wt1 = TI.interp_weights(ratio, pos)
        if rev:
            a, b = b, a
        calls = []
        TI.estimate_motion(TI.build_pyramid(a.y, w, h, levels),
                           TI.build_pyramid(b.y, w, h, levels), w, h,
                           (wt0, wt1), on_level=lambda *c: calls.append(c))
        for lvl, args, kw, maps in calls:
            bw, bh = TI.me_grid(kw["w"], kw["h"])
            pre = torch.zeros((5, bh, bw), dtype=torch.int32, device=dev)
            outs = {k: torch.empty_like(pre) for k in libs}
            guided = kw["guided"]

            def run(k):
                pre.zero_()
                err = libs[k].thor_interp_me_level(
                    args[0].data_ptr(), args[1].data_ptr(), kw["w"], kw["h"],
                    kw["pad"], wt0, wt1, int(guided),
                    args[2].data_ptr() if guided else None,
                    args[3].data_ptr() if guided else None, pre.data_ptr(),
                    outs[k].data_ptr(), None,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{k}: launch failed ({err})")

            res = [(k, S.time_ms(lambda: run(k), warmup=1, iters=5))
                   for k in ("other", "tree", "tree", "other")]
            same = bool((outs["other"] == outs["tree"]).all()) and \
                bool((outs["tree"] == torch.stack(maps)).all())
            print(f"{label} ({ratio},{pos}) level {lvl} "
                  f"{kw['w']}x{kw['h']}: outputs "
                  f"{'equal' if same else 'DIFFER'}; "
                  + " ".join(f"{k}={ms:.3f}ms" for k, ms in res), flush=True)


if __name__ == "__main__":
    main(sys.argv)
