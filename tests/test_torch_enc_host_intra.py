"""The port's host mirror encoder writes thor_tpu's mirror bytes for the
all-intra golden (CIF, RDOQ, a delta-QP trial per superblock, block
contexts) and decodes to its reconstruction (see check_host_golden).
Tolerance: equal bytes, equal planes."""

from .test_torch_enc_host import check_host_golden


def test_host_intra_cif_writes_the_golden(tmp_path):
    check_host_golden("host_intra_cif", tmp_path)
