"""Sequence header (dec/maindec.c:124-147).

Frame-level syntax is parsed by the native C layer
(thor_tpu_torch.native.parse_frame).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bitstream.reader import BitReader


@dataclass
class SequenceHeader:
    width: int
    height: int
    pb_split: int
    tb_split_enable: int
    max_num_ref: int
    interp_ref: int
    max_delta_qp: int
    deblocking: int
    clpf: int
    use_block_contexts: int
    bipred: int

    @classmethod
    def read(cls, br: BitReader) -> "SequenceHeader":
        return cls(
            width=br.getbits(16),
            height=br.getbits(16),
            pb_split=br.getbits(1),
            tb_split_enable=br.getbits(1),
            max_num_ref=br.getbits(2) + 1,
            interp_ref=br.getbits(1),
            max_delta_qp=br.getbits(3),
            deblocking=br.getbits(1),
            clpf=br.getbits(1),
            use_block_contexts=br.getbits(1),
            bipred=br.getbits(1),
        )
