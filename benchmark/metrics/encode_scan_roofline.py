"""encode_scan_roofline: kernel 6 (csrc/enc_intra_scan.cu and the scans'
prologue of csrc/scan_common.cuh) in the traced clip, against the least
time for the intra transform units of the stream the encoder wrote,
parsed by the benchmark's frozen parse (benchmark/work.encode_scan_work).
"""

from benchmark.metrics._common import roofline
from benchmark.work import encode_scan_work

KERNELS = ("enc_intra_scan_kernel", "scan_init_kernel", "scan_owner_kernel")


def select(name):
    return any(k in name for k in KERNELS)


def read(trace):
    intra = trace.extra.get("intra")
    if not intra:
        return None
    return roofline(trace, select, *encode_scan_work(intra))
