"""The port's host mirror encoder writes thor_tpu's mirror bytes for the
P and B frame goldens (LDB with two references and bipred at QCIF and,
marked slow, CIF; RA with B frames on the synthesized reference) and
decodes to its reconstruction (see check_host_golden). Tolerance: equal
bytes, equal planes."""

import pytest

from .test_torch_enc_host import check_host_golden


@pytest.mark.parametrize("name", [
    "host_ldb_qcif", "host_ra_qcif",
    pytest.param("host_ldb_cif", marks=pytest.mark.slow)])
def test_host_pb_writes_the_golden(name, tmp_path):
    check_host_golden(name, tmp_path)
