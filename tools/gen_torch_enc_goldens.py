#!/usr/bin/env python3
"""Write the encoder goldens of the PyTorch/CUDA port.

    JAX_PLATFORMS=cpu python3 tools/gen_torch_enc_goldens.py [case ...]
    JAX_PLATFORMS=cpu python3 tools/gen_torch_enc_goldens.py --fixtures

The port's encoders (thor_tpu_torch.enc) must write the same bytes as
thor_tpu's for the same EncoderParams and input: the device encoder
(device_encode=1) and the host mirror encoder (device_encode=0, the
host_* cases). A machine with a CUDA card has no JAX, so the oracle's
streams are kept as data: this tool runs thor_tpu's encoder on crops of
the committed testdata/test_cif.yuv and writes
testdata/torch_enc_<case>.bit for every case of CASES (or the named
ones), after checking that thor_tpu's numpy decoder reproduces the
encoder's reconstruction. On a CPU (8 cores) the device cases spend their
time in XLA compiles, minutes per all-intra case and one to two and a
half hours per P/B case; the host cases are numpy, 0.5 to 2 minutes
each.

--fixtures writes testdata/torch_enc_inter_fixtures.npz instead: seeded
128x64 inputs of the P/B-frame modules (the banded windows and MC, ME, the
motion variants, the trial coding, the final reconstruction on a seeded
decided field, the C decide walk and emit) with thor_tpu's outputs. The
JAX functions run op by op (jax.disable_jit), which takes about 40
minutes where XLA's compiles of the same programs take far longer; every
output is integer data, so the two agree.

CASES and load_frames() are also what the port's tests and chip_smoke.py
encode, so the parameters live in one place. Nothing of thor_tpu or JAX
is imported until main() runs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "testdata"
CIF = (TESTDATA / "test_cif.yuv", 352, 288)

# name -> (width, height, EncoderParams fields). Frames are the top-left
# width x height crop of test_cif.yuv's first num_frames frames.
CASES = {
    # 10 intra modes, exact transforms, no block contexts
    "intra_qcif": (176, 144, dict(
        qp=32, intra_period=1, num_frames=2, device_encode=1, intra_rdo=1)),
    # 4 modes, fast transforms, a delta-QP after every 64-SB super mode
    "intra_qcif_fast": (176, 144, dict(
        qp=32, intra_period=1, num_frames=1, device_encode=1, intra_rdo=0,
        encoder_speed=2, max_delta_qp=1, use_block_contexts=1)),
    # full CIF: the frame's last superblock row is partial (288 = 4*64+32)
    "intra_cif": (352, 288, dict(
        qp=32, intra_period=1, num_frames=1, device_encode=1, intra_rdo=1,
        use_block_contexts=1)),
    # LDB: I, P, then P with two references; the second chance
    "ldb_qcif": (176, 144, dict(
        qp=32, num_frames=3, device_encode=1, max_num_ref=2,
        enable_bipred=1, use_block_contexts=1, encoder_speed=0)),
    # RA: hierarchical B frames with a synthesized reference, tb-split
    # trials and the fast paths
    "ra_qcif": (176, 144, dict(
        qp=32, num_frames=5, device_encode=1, max_num_ref=2,
        enable_bipred=1, use_block_contexts=1, num_reorder_pics=3,
        interp_ref=1, enable_tb_split=1, encoder_speed=2)),
    # the host mirror encoder (device_encode=0): thor_tpu's numpy search.
    # All-intra CIF with RDOQ and a delta-QP trial per superblock
    "host_intra_cif": (352, 288, dict(
        qp=32, intra_period=1, num_frames=1, device_encode=0, intra_rdo=1,
        rdoq=1, max_delta_qp=1, use_block_contexts=1)),
    # LDB: I, P, then P with two references and bipred
    "host_ldb_qcif": (176, 144, dict(
        qp=32, num_frames=3, device_encode=0, max_num_ref=2,
        enable_bipred=1, use_block_contexts=1)),
    # RA: hierarchical B frames predicting from the synthesized reference.
    # No tb split: thor_tpu's mirror stores a tb-split block's coded-block
    # flags unlike the decoder, so its filters leave a reconstruction the
    # stream does not decode to (tests/test_torch_enc_host.py pins it)
    "host_ra_qcif": (176, 144, dict(
        qp=32, num_frames=5, device_encode=0, num_reorder_pics=3,
        interp_ref=1, max_num_ref=2, enable_bipred=1)),
    # the LDB form at CIF: the mirror's time per frame on the card
    "host_ldb_cif": (352, 288, dict(
        qp=32, num_frames=3, device_encode=0, max_num_ref=2,
        enable_bipred=1, use_block_contexts=1)),
}


FIXTURES = TESTDATA / "torch_enc_inter_fixtures.npz"
# the fixtures' frame: 128x64 crops of test_cif.yuv frames 0-2 (the
# original is frame 1, its references frames 0 and 2), two references,
# bipred on, qp 32
FIX_W, FIX_H, FIX_QP, FIX_SEED = 128, 64, 32, 7
FIX_LAMBDA = 77.7672            # squared_lambda_QP[32], lambda_coeffP 1.0


def golden_path(name: str) -> Path:
    return TESTDATA / f"torch_enc_{name}.bit"


def crop_frames(path, src_w, src_h, width, height, num_frames):
    """First num_frames frames of a planar 4:2:0 file, cropped top-left
    to width x height: a list of (y, u, v) uint8 arrays."""
    ysz, csz = src_w * src_h, (src_w // 2) * (src_h // 2)
    out = []
    with open(path, "rb") as f:
        for _ in range(num_frames):
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                raise ValueError(f"{path}: fewer than {num_frames} frames")
            y = np.frombuffer(buf, np.uint8, ysz).reshape(src_h, src_w)
            u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(
                src_h // 2, src_w // 2)
            v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(
                src_h // 2, src_w // 2)
            out.append((y[:height, :width].copy(),
                        u[:height // 2, :width // 2].copy(),
                        v[:height // 2, :width // 2].copy()))
    return out


def load_frames(name: str):
    """(fields for EncoderParams(**fields), frames) of one case."""
    width, height, fields = CASES[name]
    fields = dict(fields, width=width, height=height)
    return fields, crop_frames(*CIF, width, height, fields["num_frames"])


def fixture_inputs():
    """The fixtures' inputs, all numpy: a dict with org_y/u/v (uint8, the
    crop of frame 1 at a seeded offset), ref_y/u/v ([2, Hp, Wp] uint8:
    frames 0 and 2, edge-padded by 96 / 48 as a reference is), sign and
    sign_bi ([2] int32: slot 0 a past reference at the frame's own number
    under bipred, slot 1 a future one), lam (float) and lam_me (float32)."""
    rng = np.random.default_rng(FIX_SEED)
    y0 = int(rng.integers(0, (288 - FIX_H) // 8)) * 8
    x0 = int(rng.integers(0, (352 - FIX_W) // 8)) * 8
    frames = crop_frames(*CIF, 352, 288, 3)

    def crop(f):
        return tuple(np.ascontiguousarray(p[y0 // k:(y0 + FIX_H) // k,
                                            x0 // k:(x0 + FIX_W) // k])
                     for p, k in zip(f, (1, 2, 2)))

    org = crop(frames[1])
    refs = [crop(frames[0]), crop(frames[2])]
    return {
        "org_y": org[0], "org_u": org[1], "org_v": org[2],
        "ref_y": np.stack([np.pad(r[0], 96, mode="edge") for r in refs]),
        "ref_u": np.stack([np.pad(r[1], 48, mode="edge") for r in refs]),
        "ref_v": np.stack([np.pad(r[2], 48, mode="edge") for r in refs]),
        "sign": np.array([0, 1], np.int32),
        "sign_bi": np.array([1, 1], np.int32),
        "lam": FIX_LAMBDA,
        "lam_me": np.float32(np.sqrt(FIX_LAMBDA)),
    }


def decided_field(rng, K):
    """A seeded decided field over the fixtures' frame: leaves of a random
    quadtree in coding order as an [n, 13] int32 array of (ypos, xpos,
    size, mode, mvx, mvy, ref, mvx1, mvy1, ref1, dir, k, cbp_kind) in the
    stream domain; mode 1 is intra, dir 2 bipred, cbp_kind 0 uncoded,
    1 coded, 2 coded tb-split."""
    out = []

    def rec(s, y, x):
        if s > 8 and rng.random() < 0.55:
            h = s // 2
            for dy, dx in ((0, 0), (h, 0), (0, h), (h, h)):
                rec(h, y + dy, x + dx)
            return
        if rng.random() < 0.15:
            out.append((y, x, s, 1) + (0,) * 9)
            return
        mv = rng.integers(-120, 121, 4)
        bi = int(rng.random() < 0.35)
        kind = int(rng.integers(0, 3 if s > 8 else 2))
        out.append((y, x, s, 3 if bi else 2, mv[0], mv[1],
                    int(rng.integers(0, 2)), mv[2] * bi, mv[3] * bi,
                    int(rng.integers(0, 2)) * bi, 2 * bi,
                    int(rng.integers(0, K)), kind))

    for y in range(0, FIX_H, 64):
        for x in range(0, FIX_W, 64):
            rec(64, y, x)
    return np.array(out, np.int32)


def random_banks(rng, K):
    """Seeded coefficient banks of every size, as the trials lay them out
    (tb banks in the quadrant layout, levels only in the transform's low
    16 x 16): {size: dict}. cbp flags are drawn apart from the levels, so
    a level under a clear flag tests the masking."""
    H, W = FIX_H, FIX_W
    banks = {}
    for s in (8, 16, 32, 64):
        N = (H // s) * (W // s)
        sc = s // 2

        def lv(b, q):
            a = rng.integers(-3, 4, (K, N, b, b)) \
                * (rng.random((K, N, b, b)) < 0.2)
            m = np.zeros((b, b), bool)
            m[:q, :q] = True
            return (a * m).astype(np.int16)

        def quads(b):
            b2 = b // 2
            q = lv(b2, min(b2, 16)).reshape(K, N, 1, b2, b2)
            q = np.concatenate([q] + [lv(b2, min(b2, 16)).reshape(
                K, N, 1, b2, b2) for _ in range(3)], axis=2)
            return q.reshape(K, N, 2, 2, b2, b2).transpose(
                0, 1, 2, 4, 3, 5).reshape(K, N, b, b)

        t = {"qy": lv(s, min(s, 16) if s < 64 else 16),
             "qu": lv(sc, min(sc, 16)), "qv": lv(sc, min(sc, 16))}
        for c in ("cbp_y", "cbp_u", "cbp_v"):
            t[c] = rng.random((K, N)) < 0.7
        if s > 8:
            t["qy_tb"], t["qu_tb"], t["qv_tb"] = quads(s), quads(sc), \
                quads(sc)
            for c in ("cbp_tb_y", "cbp_tb_u", "cbp_tb_v"):
                t[c] = rng.integers(0, 16, (K, N)).astype(np.int32)
        banks[s] = t
    return banks


def write_fixtures():
    """Run the P/B-frame modules of thor_tpu op by op on the fixtures'
    inputs and write their outputs to FIXTURES."""
    import time

    import jax
    import jax.numpy as jnp

    from thor_tpu.bitstream.writer import BitWriter
    from thor_tpu.codec.blockdata import DeblockData
    from thor_tpu.codec.constants import CHROMA_QP
    from thor_tpu.enc import device_inter as DI
    from thor_tpu.enc.device_me import me_frame_body
    from thor_tpu.ops import jax_kernels as JK
    from thor_tpu.ops.banded_mc import M_CHROMA, M_LUMA, mc_pred_banded
    from thor_tpu.ops.windowed import banded_windows, banded_windows_stack

    t0 = time.time()
    inp = fixture_inputs()
    rng = np.random.default_rng(FIX_SEED)
    H, W = FIX_H, FIX_W
    qpY, qpC = FIX_QP, int(CHROMA_QP[FIX_QP])
    out = {}
    refY, refU, refV = (jnp.asarray(inp[k]) for k in
                        ("ref_y", "ref_u", "ref_v"))
    orgY, orgU, orgV = (jnp.asarray(inp[k]) for k in
                        ("org_y", "org_u", "org_v"))
    sign, sign_bi = jnp.asarray(inp["sign"]), jnp.asarray(inp["sign_bi"])
    lam_me = jnp.float32(inp["lam_me"])
    luts = {"y0": JK.build_luma_mc_lut(0), "y1": JK.build_luma_mc_lut(1),
            "c": JK.build_chroma_mc_lut()}

    with jax.disable_jit():
        # banded windows: (case, base, bstep, w, M) over the luma stack
        for i, (base, bstep, w, M) in enumerate(
                ((96, 8, 12, 18), (93, 16, 23, 40), (48, 16, 20, 9))):
            HB, WB = H // bstep, W // bstep
            dy, dx = (rng.integers(-M, M + 1, (HB, WB)).astype(np.int32)
                      for _ in range(2))
            slot = rng.integers(0, 2, (HB, WB)).astype(np.int32)
            out[f"win{i}_args"] = np.array([base, bstep, w, M], np.int32)
            out[f"win{i}_dy"], out[f"win{i}_dx"] = dy, dx
            out[f"win{i}_slot"] = slot
            out[f"win{i}"] = np.asarray(banded_windows(
                refY[0], jnp.asarray(dy), jnp.asarray(dx), base, base,
                bstep, w, M))
            out[f"win{i}_stack"] = np.asarray(banded_windows_stack(
                refY, jnp.asarray(slot), jnp.asarray(dy), jnp.asarray(dx),
                base, base, bstep, w, M))
        # banded MC, every size, both planes' LUTs (and luma without
        # bipred at 16); the MVs reach past +-M to hit the clamp
        for s in (8, 16, 32, 64):
            HB, WB = H // s, W // s
            for lk in (("y1", "c", "y0") if s == 16 else ("y1", "c")):
                luma = lk != "c"
                mvy, mvx = (rng.integers(-200, 201, (HB, WB)).astype(
                    np.int32) for _ in range(2))
                slot = rng.integers(0, 2, (HB, WB)).astype(np.int32)
                key = f"mc{s}_{lk}"
                out[key + "_mv"] = np.stack([slot, mvy, mvx])
                out[key] = np.asarray(mc_pred_banded(
                    refY if luma else refU, jnp.asarray(slot),
                    jnp.asarray(mvy), jnp.asarray(mvx), luts[lk],
                    96 if luma else 48, 2 if luma else 3,
                    s if luma else s // 2, -2 if luma else -1,
                    M_LUMA if luma else M_CHROMA))
        print(f"windows and banded MC: {time.time() - t0:.0f} s", flush=True)

        me = me_frame_body(H, W, 2, 1)(orgY, refY, None, lam_me)
        for s in (8, 16, 32, 64):
            for name, a in zip(("mvy", "mvx", "slot", "cost", "ref_mvy",
                                "ref_mvx"), me[s]):
                out[f"me{s}_{name}"] = np.asarray(a)
        print(f"ME: {time.time() - t0:.0f} s", flush=True)

        variants = DI._measure_fn(H, W, 2, True, 0, 1, 1)(
            orgY, refY, refU, refV, sign, sign_bi, lam_me)
        for s in (8, 16, 32, 64):
            for k, a in variants[s].items():
                out[f"var{s}_{k}"] = np.asarray(a)
        print(f"variants: {time.time() - t0:.0f} s", flush=True)

        # trials: every size at speed 0 with tb above 8 (the walk's maps),
        # and 32 at speed 2 without tb
        def trial(s, tb, speed):
            v = variants[s]
            fast32, fast64 = speed > 1, speed > 0
            t = DI._trial_fn(H, W, s, (s == 64 and fast64) or fast32,
                             fast32, True, tb, s == 64 or fast32, 1)(
                orgY, orgU, orgV, refY, refU, refV, v["mvy"], v["mvx"],
                v["slot"], v["mvy1"], v["mvx1"], v["slot1"], v["bi"],
                jnp.int32(qpY), jnp.int32(qpC), sign, sign_bi)
            return {k: np.asarray(a) for k, a in t.items()}

        trials = {s: trial(s, s > 8, 0) for s in (8, 16, 32, 64)}
        trials["32fast"] = trial(32, False, 2)
        for s, t in trials.items():
            for k, a in t.items():
                out[f"trial{s}_{k}"] = (a.astype(np.int16)
                                        if k.startswith("q") else a)
        print(f"trials: {time.time() - t0:.0f} s", flush=True)

        # final reconstruction on a seeded decided field
        K = 2
        field = decided_field(rng, K)
        banks = random_banks(rng, K)
        out["final_field"] = field
        for s, t in banks.items():
            for k, a in t.items():
                out[f"bank{s}_{k}"] = a
        H4, W4 = H // 4, W // 4
        cells = {k: np.zeros((H4, W4), np.int32) for k in (
            "size", "mvx", "mvy", "sl", "mvx1", "mvy1", "sl1", "bi")}
        sel = {s: {"k": np.zeros((H // s) * (W // s), np.int32),
                   "m": np.zeros((H // s) * (W // s), bool),
                   "mtb": np.zeros((H // s) * (W // s), bool)}
               for s in (8, 16, 32, 64)}
        sg, sgb = inp["sign"], inp["sign_bi"]
        for (y, x, s, mode, mvx, mvy, ref, mvx1, mvy1, ref1, dirf, k,
             kind) in field:
            if mode == 1:
                continue
            cy, cx, cs = y // 4, x // 4, s // 4
            reg = (slice(cy, cy + cs), slice(cx, cx + cs))
            s0 = (sgb if dirf == 2 else sg)[ref]
            cells["size"][reg] = s
            cells["mvx"][reg] = -mvx if s0 else mvx
            cells["mvy"][reg] = -mvy if s0 else mvy
            cells["sl"][reg] = ref
            if dirf == 2:
                cells["mvx1"][reg] = -mvx1 if sgb[ref1] else mvx1
                cells["mvy1"][reg] = -mvy1 if sgb[ref1] else mvy1
                cells["sl1"][reg] = ref1
                cells["bi"][reg] = 1
            idx = (y // s) * (W // s) + x // s
            sel[s]["k"][idx] = k
            if kind == 1:
                sel[s]["m"][idx] = True
            elif kind == 2:
                sel[s]["mtb"][idx] = True
        tsel = {}
        for s, t in banks.items():
            tsel[s] = {k: jnp.asarray(a) for k, a in t.items()}
            tsel[s].update(k=jnp.asarray(sel[s]["k"]),
                           m=jnp.asarray(sel[s]["m"]))
            if s > 8:
                tsel[s]["mtb"] = jnp.asarray(sel[s]["mtb"])
        y, u, v = DI._final_mc_fn(H, W, True, 1)(
            refY, refU, refV, *(jnp.asarray(cells[k]) for k in (
                "size", "mvx", "mvy", "sl", "mvx1", "mvy1", "sl1", "bi")),
            tsel, jnp.int32(qpY), jnp.int32(qpC))
        out["final_y"], out["final_u"], out["final_v"] = (
            np.asarray(a, np.int32) for a in (y, u, v))
        print(f"final reconstruction: {time.time() - t0:.0f} s", flush=True)

    # the C walk on the trials' maps, with seeded intra costs, then the C
    # emit of its leaves (seeded levels for the intra leaves)
    meas, intra_modes, intra_costs = {}, {}, {}
    lam = float(inp["lam"])
    for s in (8, 16, 32, 64):
        m = {k: out[f"var{s}_{k}"] for k in
             ("mvy", "mvx", "slot", "mvy1", "mvx1", "slot1", "bi")}
        m["K_uni"] = 5
        m.update({k: a for k, a in trials[s].items()
                  if not k.startswith("q")})
        meas[s] = m
        HB, WB = H // s, W // s
        best = (m["ssd_coded"] + lam * m["bits"]).min(axis=0)
        intra_costs[s] = (best * rng.uniform(0.6, 1.6, best.shape)) \
            .astype(np.int64).reshape(HB, WB)
        intra_modes[s] = rng.integers(0, 4, (HB, WB)).astype(np.int32)
        out[f"intra{s}_cost"] = intra_costs[s]
        out[f"intra{s}_mode"] = intra_modes[s]

    class Enc:
        pass

    enc = Enc()
    enc.width, enc.height, enc.num_ref, enc.interp_ref = W, H, 2, 0
    enc.frame_type, enc.num_intra_modes = 1, 4

    class P:
        enable_bipred, use_block_contexts, enable_tb_split = 1, 1, 1
        enable_pb_split, max_delta_qp = 0, 0

    enc.params = P
    # three walks over the same maps: the frame's lambda; a sixteenth of
    # it; a sixty-fourth of it with the intra costs of sizes 16, 32, 64
    # scaled up 3x, 5x, 10x, which splits down to 8x8 skip, intra and
    # bipred leaves beside merged 32s (26 leaves)
    for j, (lam_j, iscale) in enumerate((
            (lam, (1, 1, 1, 1)), (lam / 16, (1, 1, 1, 1)),
            (lam / 64, (1, 3, 5, 10)))):
        enc.deblock_data = DeblockData(W, H)
        costs_j = {s: (intra_costs[s] * f).astype(np.int64)
                   for s, f in zip((8, 16, 32, 64), iscale)}
        leaves, _ = DI._decide_frame_native(
            enc, meas, intra_modes, costs_j, lam_j, float(np.sqrt(lam_j)))
        out[f"walk{j}_lam"] = np.float64(lam_j)
        out[f"walk{j}_iscale"] = np.array(iscale, np.float64)
        out[f"walk{j}_leaves"] = np.array(
            [[getattr(lf, k) for k in ("ypos", "xpos", "size", "mode")]
             + [lf.mv[0], lf.mv[1], lf.ref, lf.skip_idx, lf.intra_mode,
                int(lf.use_cbp), lf.k, lf.idx, lf.mv1[0], lf.mv1[1],
                lf.ref1, lf.dir, lf.tb] for lf in leaves], np.int32)
        coeff_host = {}
        for s in (8, 16, 32, 64):
            lst = [lf for lf in leaves if lf.mode != 1 and lf.use_cbp
                   and lf.size == s]
            if not lst:
                continue
            t = trials[s]
            g = {}
            for c in ("qy", "qu", "qv"):
                a = t[c][[lf.k for lf in lst], [lf.idx for lf in lst]]
                if s > 8:
                    b = t[c + "_tb"][[lf.k for lf in lst],
                                     [lf.idx for lf in lst]]
                    a = np.where(np.array([bool(lf.tb) for lf in lst])[
                        :, None, None], b, a)
                g[c] = a
            g["index"] = {(lf.ypos, lf.xpos): i for i, lf in enumerate(lst)}
            coeff_host[s] = g
        intra = [lf for lf in leaves if lf.mode == 1]
        intra_q = {}
        if intra:
            for c in ("qy", "qu", "qv"):
                intra_q[c] = (rng.integers(-2, 3, (len(intra), 16, 16))
                              * (rng.random((len(intra), 16, 16)) < 0.1)) \
                    .astype(np.int16)
                out[f"walk{j}_intra_{c}"] = intra_q[c]
            for c, q in (("cy", "qy"), ("cu", "qu"), ("cv", "qv")):
                intra_q[c] = (intra_q[q] != 0).any(axis=(1, 2))
            intra_q["index"] = {(lf.ypos, lf.xpos): i
                                for i, lf in enumerate(intra)}
        w = BitWriter()
        w.putbits(5, 21)                    # a frame header's partial word
        enc.deblock_data = DeblockData(W, H)
        DI._emit_native(enc, w, leaves, meas, coeff_host, intra_q)
        out[f"walk{j}_emit"] = np.frombuffer(w.flush_frame(), np.uint8)
        dd = enc.deblock_data
        out[f"walk{j}_dd"] = np.stack([getattr(dd, k) for k in (
            "mode", "size", "tb_split", "pb_part", "cbp_y", "cbp_u",
            "cbp_v", "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0",
            "ref_idx1", "bipred_flag")])
        print(f"walk {j}: {len(leaves)} leaves ({len(intra)} intra)",
              flush=True)
    np.savez_compressed(FIXTURES, **out)
    print(f"{FIXTURES.name}: {FIXTURES.stat().st_size} bytes, {len(out)} "
          f"arrays, {time.time() - t0:.0f} s", flush=True)
    return 0


def main(argv):
    import hashlib
    import time

    if argv == ["--fixtures"]:
        return write_fixtures()

    from thor_tpu.dec.decoder import decode_file
    from thor_tpu.enc.encoder import Encoder, EncoderParams

    for name in argv or list(CASES):
        fields, frames = load_frames(name)
        out = golden_path(name)
        # thor_tpu opens its output at the start and closes it at the end:
        # write beside the golden and rename, so that a copy of the tree
        # taken meanwhile never holds an empty or partial golden
        part = out.with_name(out.name + ".part")
        t0 = time.time()
        recons = Encoder(EncoderParams(**fields)).encode_sequence(
            frames, str(part))
        dec = decode_file(str(part), backend="numpy")
        ok = len(dec) == len(recons) and all(
            np.array_equal(a, b) for d, r in zip(dec, recons)
            for a, b in zip(d, r))
        sha = hashlib.sha256(part.read_bytes()).hexdigest()
        print(f"{out.name}: {part.stat().st_size} bytes, sha256 {sha}, "
              f"{len(recons)} frames, {time.time() - t0:.0f} s, numpy decode "
              f"{'equals' if ok else 'DIFFERS FROM'} the reconstruction",
              flush=True)
        if not ok:
            part.unlink()
            return 1
        part.replace(out)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
