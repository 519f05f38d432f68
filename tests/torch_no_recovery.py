"""The ``no_recovery`` fixture of the port's tests.

The BLS supervisor (``lighthouse_tpu_torch/crypto/bls/api.py``, on by
default) answers a batch on the port's pure-Python reference rung when a
device backend raises a device fault, and the pubkey plane and the gossip
ingest have host rungs of their own.  A verdict alone then cannot show that
the code under test answered: a test that holds a device path to the JAX
package uses this fixture, which fails it when a fault or a recovery was
counted while it ran, or when a breaker was open before or after it (an
open breaker sends a batch past the backend under test).  Import it into
a test module and name it in ``pytestmark`` or in
``pytest.mark.usefixtures``.
"""

import pytest

from lighthouse_tpu_torch.crypto.bls import api


@pytest.fixture
def no_recovery():
    # an open breaker would hand the batch to the next rung of the ladder
    assert set(api.backend_health().values()) == {"closed"}, api.backend_health()
    before = api.faults(), api.recoveries()
    yield
    after = api.faults(), api.recoveries()
    assert after == before, (f"a device fault was caught and recovered on the host: faults "
                             f"{before[0]} -> {after[0]}, recoveries {before[1]} -> {after[1]}")
    assert set(api.backend_health().values()) == {"closed"}, api.backend_health()
