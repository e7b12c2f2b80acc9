"""Block-level records the syntax writers consume.

Counterpart of the dataclasses of thor_tpu/enc/block.py. The host mirror
search of that module (process_block and what it calls) belongs to the
device_encode=0 path and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..codec.constants import MODE_DC, MODE_SKIP


@dataclass
class BlockParam:
    """block_param_t (common/types.h:153-170)."""
    mode: int = MODE_SKIP
    intra_mode: int = MODE_DC
    tb_param: int = 0
    tb_split: int = 0
    pb_part: int = 0
    skip_idx: int = 0
    ref_idx0: int = 0
    ref_idx1: int = 0
    dir: int = 0
    mv_arr0: tuple = (((0, 0),) * 4)
    mv_arr1: tuple = (((0, 0),) * 4)
    cbp: tuple = (0, 0, 0)
    coeff_y: Optional[np.ndarray] = None
    coeff_u: Optional[np.ndarray] = None
    coeff_v: Optional[np.ndarray] = None


@dataclass
class BlockInfo:
    """block_info_t subset used by the syntax writers."""
    size: int = 0
    ypos: int = 0
    xpos: int = 0
    bwidth: int = 0
    bheight: int = 0
    max_num_tb_part: int = 1
    max_num_pb_part: int = 1
    delta_qp: int = 0
    block_context: object = None
    mvp: tuple = (0, 0)
    num_skip_vec: int = 0
    num_merge_vec: int = 0
    skip_candidates: list = field(default_factory=list)
    merge_candidates: list = field(default_factory=list)
    block_param: BlockParam = field(default_factory=BlockParam)
