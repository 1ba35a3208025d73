"""The port's lock-order witness for the port's storage tests.

Import `port_witness` into a test module: it turns the witness of
`repro_torch.analysis.witness` on before each test (so the stores the test
makes get ranked locks) and fails the test on any violation the witness
recorded, as tests/conftest.py does for the reference's witness.
"""
import pytest

from repro_torch.analysis import witness


@pytest.fixture(autouse=True)
def port_witness():
    witness.enable()
    witness.GLOBAL.take_violations()
    try:
        yield witness.GLOBAL
    finally:
        witness.enable(False)
    found = witness.GLOBAL.take_violations()
    if found:
        pytest.fail("port lock-order witness recorded %d violation(s):\n\n%s"
                    % (len(found), "\n\n".join(v.format() for v in found)),
                    pytrace=False)
