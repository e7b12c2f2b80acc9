#!/usr/bin/env python3
"""A/B of two builds of one of the port's CUDA kernels on one CUDA card.

    python3 tools/ab_kernel.py interp_me other_interp_me.cu
    python3 tools/ab_kernel.py intra_scan other_intra_scan.cu
    python3 tools/ab_kernel.py enc_intra_scan other_enc_intra_scan.cu
    python3 tools/ab_kernel.py mc other_mc.cu
    python3 tools/ab_kernel.py interp_mc other_interp_mc.cu

Builds thor_tpu_torch/csrc/<kernel>.cu ("tree") and the given source
("other", for instance an earlier commit's file written out with
`git show REV:thor_tpu_torch/csrc/<kernel>.cu`; it includes the headers
beside it first, then the tree's from csrc/, so an older source builds
against its own `git show` copies of the headers it names). Runs both on
the same inputs,
in the order other, tree, tree, other, and prints the device ms of each
run (CUDA events around a CUDA-graph replay of 5 calls) and whether the
two outputs are equal to each other and to the main path's.

interp_me: every pyramid level of two 1080p frame pairs, seeded
correlated noise frames and the first interpolated frame of
testdata/RA16_high_efficiency_1080.bit; both sources have the C entry
thor_interp_me_level of the tree's signature, and the scratch (sized as
the tree's kernel wants it) is zeroed before every launch of either. The
two SAD counters (`stats`) of both builds are printed and compared.

intra_scan: the Y and the U/V launch of the I frame and of the first P
frame of testdata/LDB_medium_complexity_1080.bit. An "other" source
without a `scratch` argument is called with the single-block entry's
signature (planes updated in place, no input copy, no scratch).

enc_intra_scan: the Y and the U/V launch of the first frame of the 1080p
all-intra encode (chip_smoke.ENC_1080: its search on the card, its
records); the planes and the coefficient banks are compared. An "other"
source without a `scratch` argument is called with the single-block
entry's signature (planes updated in place).

mc: the Y and the U/V launch of the first P frame of
testdata/LDB_medium_complexity_1080.bit; both sources have the entry
thor_mc_frame of the tree's signature, and the output is cleared before
every launch of either, as the wrapper does.

interp_mc: the synthesis of the first interpolated frame of
testdata/RA16_high_efficiency_1080.bit from level 0's maps to the three
padded reference planes: the two stacks of ops/interp.cell_vectors, then
Y, then U+V, timed apart and together. A source with the entry
thor_interp_mot_comp_uv (the padded, derived-vector kernels) is called as
the tree's is; an earlier one (thor_interp_mot_comp alone, [h, w] planes,
explicit chroma vectors) is called as the parent's interpolate_frames
called it: the kernel, the chroma vectors in tensor ops and an edge_pad
of each plane. Also one torch.profiler run of each build's whole
synthesis: its kernels, launches and device ms.

Run from the repo's root; needs a CUDA device; imports nothing of JAX.
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
from thor_tpu_torch.ops import enc_intra as EI            # noqa: E402
from thor_tpu_torch.ops import interp as TI               # noqa: E402
from thor_tpu_torch.ops import intra as IT                # noqa: E402
from thor_tpu_torch.ops import mc as M                    # noqa: E402

ORDER = ("other", "tree", "tree", "other")
VP, CI = ctypes.c_void_p, ctypes.c_int


def load(kernel: str, other: Path):
    """{"other", "tree"} -> CDLL, both built in one round."""
    flags = _build.NVCC_FLAGS + ("-I", str(_build.CSRC))
    jobs = [(f"{kernel}_{name}", (_build.nvcc(),), src, flags)
            for name, src in (("other", other),
                              ("tree", _build.CSRC / f"{kernel}.cu"))]
    paths = _build.build_shared(jobs)
    return {name: ctypes.CDLL(str(paths[f"{kernel}_{name}"]))
            for name in ("other", "tree")}


def report(label, outs, main_path, res, extra=""):
    same = bool((outs["other"] == outs["tree"]).all()) and \
        bool((outs["tree"] == main_path).all())
    print(f"{label}: outputs {'equal' if same else 'DIFFER'}{extra}; "
          + " ".join(f"{k}={ms:.4f}ms" for k, ms in res), flush=True)
    return same


def ab_interp_me(libs, dev):
    for L in libs.values():
        L.thor_interp_me_level.restype = CI
        L.thor_interp_me_level.argtypes = [VP, VP] + [CI] * 6 + [VP] * 6
    ok = True
    r1, r2, ratio, pos = S.first_interp_pair(dev)
    for label, a, b, (ratio, pos) in (
            ("seeded", *S.correlated_frames(8, 1920, 1080, (2, 3), dev),
             (2, 1)),
            ("stream", r1, r2, (ratio, pos))):
        calls = []
        _, _, _, (wt0, wt1), _, _ = TI.level0_motion(
            a, b, ratio, pos, on_level=lambda *c: calls.append(c))
        for lvl, args, kw, maps in calls:
            bw, bh = TI.me_grid(kw["w"], kw["h"])
            pre = torch.zeros(5 * bh * bw + bh // 2 + 1, dtype=torch.int32,
                              device=dev)
            outs = {k: torch.empty((5, bh, bw), dtype=torch.int32,
                                   device=dev) for k in libs}
            guided = kw["guided"]

            def run(k, stats=None):
                pre.zero_()
                err = libs[k].thor_interp_me_level(
                    args[0].data_ptr(), args[1].data_ptr(), kw["w"], kw["h"],
                    kw["pad"], wt0, wt1, int(guided),
                    args[2].data_ptr() if guided else None,
                    args[3].data_ptr() if guided else None, pre.data_ptr(),
                    outs[k].data_ptr(),
                    stats.data_ptr() if stats is not None else None,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{k}: launch failed ({err})")

            stats = {k: torch.zeros(2, dtype=torch.int64, device=dev)
                     for k in libs}
            for k in libs:
                run(k, stats[k])
            st = {k: v.tolist() for k, v in stats.items()}
            res = [(k, S.time_ms(lambda: run(k), warmup=1, iters=5))
                   for k in ORDER]
            ok &= report(
                f"interp_me {label} ({ratio},{pos}) level {lvl} "
                f"{kw['w']}x{kw['h']}", outs, torch.stack(maps), res,
                f", SAD counters other {st['other']} tree {st['tree']} "
                f"{'equal' if st['other'] == st['tree'] else 'DIFFER'}")
            ok &= st["other"] == st["tree"]
    return ok


def ab_intra_scan(libs, dev, other_has_scratch):
    new_sig = [VP, VP, VP, CI, CI, CI, VP, CI, VP, VP]
    old_sig = [VP, VP, CI, CI, CI, VP, CI, VP]
    for k, L in libs.items():
        L.thor_intra_scan.restype = CI
        L.thor_intra_scan.argtypes = new_sig \
            if k == "tree" or other_has_scratch else old_sig
    from thor_tpu_torch.dec.reconstruct import residual_planes
    seq, _, (cfg0, inp0), (cfg1, inp1, _) = S.first_frames(dev)
    H, W = seq.height, seq.width
    ok = True
    for frame, cfg, inp in (("I", cfg0, inp0), ("P", cfg1, inp1)):
        ry, rc = residual_planes(cfg, inp, dev)
        for label, resid, recs in (("Y", ry[None].contiguous(), inp["it_y"]),
                                   ("UV", rc, inp["it_c"])):
            C, h, w = resid.shape
            planes = torch.zeros_like(resid)
            n = len(recs)
            # room for either build's scratch
            scratch = torch.empty(IT.scan_scratch(C, h, w, n, dev).numel()
                                  + n * C, dtype=torch.int32, device=dev)
            outs = {k: torch.empty_like(planes) for k in libs}

            def run(k):
                # inside a graph capture the current stream is another one
                stream = torch.cuda.current_stream(dev).cuda_stream
                outs[k].copy_(planes)
                if k == "tree" or other_has_scratch:
                    err = libs[k].thor_intra_scan(
                        planes.data_ptr(), outs[k].data_ptr(),
                        resid.data_ptr(), C, h, w, recs.data_ptr(), n,
                        scratch.data_ptr(), stream)
                else:
                    err = libs[k].thor_intra_scan(
                        outs[k].data_ptr(), resid.data_ptr(), C, h, w,
                        recs.data_ptr(), n, stream)
                if err:
                    raise RuntimeError(f"{k}: launch failed ({err})")

            res = [(k, S.time_ms(lambda: run(k), warmup=1, iters=5))
                   for k in ORDER]
            chain = int(IT.intra_levels(recs.cpu().numpy()).max())
            ok &= report(f"intra_scan 1080p {frame} frame {label}, {n} TUs, "
                         f"chain {chain}", outs,
                         IT.intra_scan(planes, resid, recs), res)
    return ok


def ab_enc_intra_scan(libs, dev, other_has_scratch):
    from thor_tpu_torch.codec.constants import GDEQUANT_TABLE, GQUANT_TABLE
    new_sig = [VP, VP, VP, CI, CI, CI, VP, CI, VP, VP] + [CI] * 6 + [VP]
    old_sig = [VP, VP, CI, CI, CI, VP, CI, VP] + [CI] * 6 + [VP]
    for k, L in libs.items():
        L.thor_enc_intra_scan.restype = CI
        L.thor_enc_intra_scan.argtypes = new_sig \
            if k == "tree" or other_has_scratch else old_sig
    y, u, v, (recs_y, qpY), (recs_c, qpC) = S.enc_frame0(dev)
    ok = True
    for label, org, recs, qp in (("Y", y[None], recs_y, qpY),
                                 ("UV", torch.stack([u, v]), recs_c, qpC)):
        C, h, w = org.shape
        org = org.contiguous()
        recs = torch.from_numpy(recs).to(dev)
        n = len(recs)
        planes = torch.zeros_like(org)
        scratch = EI.scan_scratch(h, w, dev)
        outs = {k: torch.empty_like(planes) for k in libs}
        banks = {k: torch.empty((n, C, 16, 16), dtype=torch.int16, device=dev)
                 for k in libs}
        gdq = int(GDEQUANT_TABLE[qp % 6])
        quant = (int(GQUANT_TABLE[qp % 6]), qp // 6, gdq << (qp // 6),
                 73 * gdq, 0, 1)

        def run(k):
            stream = torch.cuda.current_stream(dev).cuda_stream
            outs[k].copy_(planes)
            if k == "tree" or other_has_scratch:
                err = libs[k].thor_enc_intra_scan(
                    planes.data_ptr(), outs[k].data_ptr(), org.data_ptr(), C,
                    h, w, recs.data_ptr(), n, scratch.data_ptr(),
                    banks[k].data_ptr(), *quant, stream)
            else:
                err = libs[k].thor_enc_intra_scan(
                    outs[k].data_ptr(), org.data_ptr(), C, h, w,
                    recs.data_ptr(), n, banks[k].data_ptr(), *quant, stream)
            if err:
                raise RuntimeError(f"{k}: launch failed ({err})")

        res = [(k, S.time_ms(lambda: run(k), warmup=1, iters=5))
               for k in ORDER]
        chain, widest = S.chain_stats(recs)
        main_p, main_q = EI.encode_scan(planes, org, recs, qp, False, True)
        same_q = torch.equal(banks["other"], banks["tree"]) and \
            torch.equal(banks["tree"], main_q)
        ok &= report(f"enc_intra_scan 1080p I frame {label}, {n} TUs, chain "
                     f"{chain}, widest level {widest}", outs, main_p, res,
                     f", banks {'equal' if same_q else 'DIFFER'}") and same_q
    return ok


def ab_mc(libs, dev):
    for L in libs.values():
        L.thor_mc_frame.restype = CI
        L.thor_mc_frame.argtypes = [VP, CI, CI, CI, CI, VP, CI, VP, CI, VP,
                                    CI, CI, VP]
    seq, luts, _, (_, inp1, refs1) = S.first_frames(dev)
    H, W = seq.height, seq.width
    refY = torch.stack([r.y for r in refs1])[None]
    refUV = torch.stack([torch.stack([r.u for r in refs1]),
                         torch.stack([r.v for r in refs1])])
    ok = True
    for label, refs, recs, lut, h, w in (
            ("Y", refY, inp1["mc_y"], luts[0], H, W),
            ("UV", refUV, inp1["mc_c"], luts[1], H // 2, W // 2)):
        C, R, Hp, Wp = refs.shape
        T = int(round(lut.shape[1] ** 0.5))
        outs = {k: torch.empty((C, h, w), dtype=torch.int32, device=dev)
                for k in libs}

        def run(k):
            outs[k].zero_()
            err = libs[k].thor_mc_frame(
                refs.data_ptr(), C, R, Hp, Wp, recs.data_ptr(), len(recs),
                lut.data_ptr(), T, outs[k].data_ptr(), h, w,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{k}: launch failed ({err})")

        res = [(k, S.time_ms(lambda: run(k))) for k in ORDER]
        ok &= report(f"mc 1080p P frame {label}, {len(recs)} records", outs,
                     M.mc_frame(refs, recs, lut, h, w), res)
    return ok


def ab_interp_mc(libs, dev, other_padded):
    from thor_tpu_torch.ops.kernels import edge_pad
    from thor_tpu_torch.utils.profile_decode import profile_run
    new_style = {k: k == "tree" or other_padded for k in libs}
    for k, L in libs.items():
        L.thor_interp_mot_comp.restype = CI
        if new_style[k]:
            L.thor_interp_mot_comp.argtypes = [VP] * 5 + [CI] * 6 + [VP]
            L.thor_interp_mot_comp_uv.restype = CI
            L.thor_interp_mot_comp_uv.argtypes = [VP] * 7 + [CI] * 8 + [VP]
        else:
            L.thor_interp_mot_comp.argtypes = [VP] * 8 + [CI] * 7 + [VP]
    r1, r2, ratio, pos = S.first_interp_pair(dev)
    a, b, maps, (wt0, wt1), w, h = TI.level0_motion(r1, r2, ratio, pos)
    PY, PC = TI.PAD_Y, TI.PAD_C
    m0, m1 = TI.cell_vectors(maps)
    bh, bw = m1.shape[:2]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def check(k, err):
        if err:
            raise RuntimeError(f"{k}: launch failed ({err})")

    def luma(k, m0, m1):
        L, s = libs[k], torch.cuda.current_stream(dev).cuda_stream
        if new_style[k]:
            yp = torch.empty((h + 2 * PY, w + 2 * PY), dtype=torch.uint8,
                             device=dev)
            check(k, L.thor_interp_mot_comp(
                ptr(a.y), ptr(b.y), ptr(yp), ptr(m0), ptr(m1), bw, bh, w, h,
                PY, PY, s))
            return (yp,)
        y = torch.empty((h, w), dtype=torch.uint8, device=dev)
        check(k, L.thor_interp_mot_comp(
            ptr(a.y), ptr(b.y), ptr(y), None, None, None, ptr(m0), ptr(m1),
            bw, bh, w, h, 8, 4, PY, s))
        return (edge_pad(y, PY),)

    def chroma(k, m1):
        L, s = libs[k], torch.cuda.current_stream(dev).cuda_stream
        hc, wc = h // 2, w // 2
        if new_style[k]:
            up, vp = (torch.empty((hc + 2 * PC, wc + 2 * PC),
                                  dtype=torch.uint8, device=dev)
                      for _ in range(2))
            check(k, L.thor_interp_mot_comp_uv(
                ptr(a.u), ptr(b.u), ptr(a.v), ptr(b.v), ptr(up), ptr(vp),
                ptr(m1), bw, bh, wc, hc, PC, PC, wt0, wt1, s))
            return up, vp
        c0, c1 = TI.chroma_vectors(m1, (wt0, wt1))
        u, v = (torch.empty((hc, wc), dtype=torch.uint8, device=dev)
                for _ in range(2))
        check(k, L.thor_interp_mot_comp(
            ptr(a.u), ptr(b.u), ptr(u), ptr(a.v), ptr(b.v), ptr(v), ptr(c0),
            ptr(c1), bw, bh, wc, hc, 4, 2, PC, s))
        return edge_pad(u, PC), edge_pad(v, PC)

    def whole(k):
        m0, m1 = TI.cell_vectors(maps)
        return luma(k, m0, m1) + chroma(k, m1)

    main_path = TI.synthesize(a, b, maps, (wt0, wt1), w, h)[3:]
    ok = True
    for label, fn, want in (
            ("Y", lambda k: luma(k, m0, m1), main_path[:1]),
            ("U+V", lambda k: chroma(k, m1), main_path[1:]),
            ("whole synthesis from level 0's maps", whole, main_path)):
        outs = {k: fn(k) for k in libs}
        res = [(k, S.time_ms(lambda: fn(k))) for k in ORDER]
        same = all(torch.equal(g, t) for k in libs
                   for g, t in zip(outs[k], want))
        print(f"interp_mc 1080p RA16 first interpolated frame ({ratio},"
              f"{pos}) {label}: padded planes "
              f"{'equal' if same else 'DIFFER'}; "
              + " ".join(f"{k}={ms:.4f}ms" for k, ms in res), flush=True)
        ok &= same
    for k in ("other", "tree"):
        whole(k)
        torch.cuda.synchronize()
        _, _, groups, top, n, _ = profile_run(lambda: whole(k))
        print(f"interp_mc {k} whole synthesis under torch.profiler: {n} "
              f"kernels, device {sum(groups.values()):.4f} ms: "
              + "; ".join(f"{c} x {name} {ms:.4f} ms" for ms, c, name in top),
              flush=True)
    return ok


KERNELS = ("interp_me", "intra_scan", "enc_intra_scan", "mc", "interp_mc")


def main(argv):
    if len(argv) != 3 or argv[1] not in KERNELS:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernel needs a CUDA device")
    other = Path(argv[2])
    libs = load(argv[1], other)
    dev = torch.device("cuda")
    scratch = "void* scratch" in other.read_text()
    if argv[1] == "interp_me":
        ok = ab_interp_me(libs, dev)
    elif argv[1] == "intra_scan":
        ok = ab_intra_scan(libs, dev, scratch)
    elif argv[1] == "enc_intra_scan":
        ok = ab_enc_intra_scan(libs, dev, scratch)
    elif argv[1] == "interp_mc":
        ok = ab_interp_mc(libs, dev,
                          "thor_interp_mot_comp_uv" in other.read_text())
    else:
        ok = ab_mc(libs, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
