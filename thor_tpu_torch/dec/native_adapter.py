"""The native C parse turned into a FrameSyntax (thor_tpu
dec/native_adapter.py:23-72), so that the numpy backend
(dec/reconstruct_np.py) reconstructs frames of either parser."""

from __future__ import annotations

from ..codec.blockdata import DeblockData
from ..native import parse_frame, seqhdr_from_python
from .parse import BlockRec, FrameSyntax


def native_parse_to_syntax(payload: bytes, start_bit: int, seq,
                           ref_frame_nums) -> FrameSyntax:
    nf = parse_frame(payload, start_bit, seqhdr_from_python(seq),
                     ref_frame_nums)
    fh = nf.hdr

    dd = DeblockData.__new__(DeblockData)
    dd.width, dd.height = seq.width, seq.height
    dd.gh, dd.gw = seq.height // 4, seq.width // 4
    for k, v in nf.dd.items():
        setattr(dd, k, v)

    nsb_v, nsb_h = seq.height // 64, seq.width // 64
    fs = FrameSyntax(
        frame_type=fh.frame_type, stat_frame_type=fh.stat_frame_type,
        qp=fh.qp, num_intra_modes=fh.num_intra_modes, num_ref=fh.num_ref,
        ref_array=[fh.ref_array[i] for i in range(fh.num_ref)],
        interp_ref_frame=bool(fh.interp_ref_frame),
        display_frame_num=fh.display_frame_num, deblock_data=dd,
        clpf_frame_enable=fh.clpf_frame_enable, clpf_all=fh.clpf_all,
        clpf_bits=(nf.clpf_bits[:nsb_v * nsb_h].reshape(nsb_v, nsb_h)
                   if fh.clpf_frame_enable and not fh.clpf_all else None))

    W, H = seq.width, seq.height
    for i in range(nf.n):
        size = int(nf.size[i])
        sc = size // 2
        oy = int(nf.coff_y[i])
        ou = int(nf.coff_u[i])
        ov = int(nf.coff_v[i])
        cbp = int(nf.cbp[i])
        rec = BlockRec(
            ypos=int(nf.ypos[i]), xpos=int(nf.xpos[i]), size=size,
            bwidth=min(size, W - int(nf.xpos[i])),
            bheight=min(size, H - int(nf.ypos[i])),
            mode=int(nf.mode[i]), qp=int(nf.qp[i]),
            intra_mode=int(nf.intra_mode[i]),
            tb_split=int(nf.tb_split[i]),
            dir=int(nf.dir[i]), ref_idx0=int(nf.ref_idx0[i]),
            ref_idx1=int(nf.ref_idx1[i]),
            mv_arr0=tuple((int(nf.mv0x[i, k]), int(nf.mv0y[i, k]))
                          for k in range(4)),
            mv_arr1=tuple((int(nf.mv1x[i, k]), int(nf.mv1y[i, k]))
                          for k in range(4)),
            cbp=(cbp & 1, (cbp >> 1) & 1, (cbp >> 2) & 1),
            coeff_y=nf.coeff_y[oy:oy + size * size].reshape(size, size),
            coeff_u=nf.coeff_u[ou:ou + sc * sc].reshape(sc, sc),
            coeff_v=nf.coeff_v[ov:ov + sc * sc].reshape(sc, sc))
        fs.blocks.append(rec)
    return fs
