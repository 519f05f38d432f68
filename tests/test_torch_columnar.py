"""The port's columnar wire decode (``ssz/columnar.py``) against the JAX
package's on the same blobs, on the CPU at the minimal preset.

Valid single-bit and aggregate Deneb attestations, targeted mutations of
them (truncation, a missing delimiter, a wrong offset, an over-long
bitlist, trailing bytes) and pure garbage go through both decoders: the
decoded columns, the group keys and the malformed rows must be equal, and
``validate_blob`` must agree with both packages' scalar deserialize.
"""

import numpy as np
import pytest

from lighthouse_tpu import types as JT
from lighthouse_tpu.ssz import columnar as jcol
from lighthouse_tpu_torch.ssz import columnar
from lighthouse_tpu_torch.types import ChainSpec, make_types

SPEC = ChainSpec.minimal()
ATT = make_types(SPEC.preset).Attestation
JATT = JT.make_types(JT.ChainSpec.minimal().preset).Attestation
LAYOUT = columnar.layout_for(SPEC.preset)
JLAYOUT = jcol.layout_for(JT.ChainSpec.minimal().preset, False)
COLUMNS = ("row_index", "slot", "index", "beacon_block_root", "source_epoch", "target_epoch",
           "target_root", "data_raw", "signature", "bit_count", "set_bits", "first_bit")


def _att(rng, n_bits=None, single=False):
    n = int(rng.integers(1, 40)) if n_bits is None else n_bits
    bits = [False] * n
    if single:
        bits[int(rng.integers(0, n))] = True
    else:
        bits = [bool(b) for b in rng.integers(0, 2, n)]
    data = JT.AttestationData(
        slot=int(rng.integers(0, 100)), index=int(rng.integers(0, 4)),
        beacon_block_root=bytes(rng.bytes(32)),
        source=JT.Checkpoint(epoch=int(rng.integers(0, 4)), root=bytes(rng.bytes(32))),
        target=JT.Checkpoint(epoch=int(rng.integers(0, 8)), root=bytes(rng.bytes(32))))
    return JATT(aggregation_bits=bits, data=data, signature=bytes(rng.bytes(96)))


def _mutations(blob, rng):
    over = blob[:LAYOUT.head] + bytes([0xFF] * (LAYOUT.bits_limit // 8) + [0x03])
    return [blob[:int(rng.integers(0, len(blob)))], blob[:-1] + b"\x00",
            b"\x00" * 4 + blob[4:], bytes([blob[0] ^ 1]) + blob[1:],
            blob + bytes(rng.bytes(int(rng.integers(1, 8)))), over]


def _scalar_ok(cls, blob) -> bool:
    try:
        cls.deserialize(blob)
        return True
    except Exception:
        return False


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(48):
        blob = _att(rng, single=i % 2 == 0).serialize()
        if i % 5 == 4:
            blobs.extend(_mutations(blob, rng)[int(rng.integers(0, 6))] for _ in range(2))
        elif i % 7 == 3:
            blobs.append(bytes(rng.bytes(int(rng.integers(0, 300)))))
        else:
            blobs.append(blob)
    return blobs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decoded_columns_equal_the_jax_decoder(seed):
    blobs = _batch(seed)
    cols, malformed = columnar.decode_batch(blobs, LAYOUT, cls=ATT)
    jcols, jmalformed = jcol.decode_batch(blobs, JLAYOUT, cls=JATT)
    assert malformed == jmalformed and malformed
    assert malformed == [i for i, b in enumerate(blobs) if not _scalar_ok(JATT, b)]
    assert cols.n == jcols.n == len(blobs) - len(malformed)
    for name in COLUMNS:
        assert np.array_equal(getattr(cols, name), getattr(jcols, name)), name
    for a, b in zip(cols.group_keys(), jcols.group_keys()):
        assert np.array_equal(a, b)
    for j in range(0, cols.n, 5):
        got, want = cols.materialize(j), jcols.materialize(j)
        assert got.serialize() == want.serialize()
        assert list(got.aggregation_bits) == list(want.aggregation_bits)


@pytest.mark.parametrize("seed", [4, 5])
def test_validate_blob_is_scalar_deserialize(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        blob = _att(rng).serialize()
        for m in [blob] + _mutations(blob, rng) + [bytes(rng.bytes(int(rng.integers(0, 400))))]:
            ok = columnar.validate_blob(m, LAYOUT)
            assert ok == _scalar_ok(ATT, m) == _scalar_ok(JATT, m) == \
                jcol.validate_blob(m, JLAYOUT), m.hex()[:40]


def test_empty_batch_and_electra():
    cols, malformed = columnar.decode_batch([], LAYOUT, cls=ATT)
    assert cols.n == 0 and malformed == []
    assert all(k.size == 0 for k in cols.group_keys())
    with pytest.raises(NotImplementedError, match="A 16"):
        columnar.layout_for(SPEC.preset, electra=True)
