"""The port's whole BLS slice, ``verify_signature_sets(sets, backend="cuda")``,
against the JAX package's verdicts on the same batches.

The batches are built with the JAX package's keys and signatures and
carried into the port through their bytes
(``convert.signature_sets_from_bytes``).  The port runs its plain versions
on the CPU (``device="cpu"``).  Its verdict must equal the JAX
``reference`` backend's on every batch; the A/B against the JAX ``tpu``
backend costs minutes of XLA compile per shape on the CPU and is marked
``slow``.
"""

import functools

import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.bls import curve as jcv
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.convert import signature_sets_from_bytes
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.ops import bls_backend as bb
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _keys(n: int, base: int = 21):
    sks = [jbls.SecretKey(base + i) for i in range(n)]
    return sks, [sk.public_key() for sk in sks]


@functools.cache
def _batch(case: str) -> tuple:
    """JAX-package signature sets for one case: five single-key sets over
    distinct messages, plus a sync-committee-like set of 18 members with
    duplicate keys (so the device pubkey aggregation runs), then the
    case's change."""
    sks, pks = _keys(8)
    msgs = [bytes([0x60 + i]) * 32 for i in range(6)]
    sets = [jbls.SignatureSet(sks[i].sign(msgs[i]), [pks[i]], msgs[i]) for i in range(5)]
    members = [2, 2, 5, 7, 7, 7] + list(range(8)) + [1, 1, 3, 0]
    sk_sum = sum(sks[i].k for i in members)
    sets.append(jbls.SignatureSet(jbls.SecretKey(sk_sum % jcv.R).sign(msgs[5]),
                                  [pks[i] for i in members], msgs[5]))
    if case == "tampered":
        sets[2] = jbls.SignatureSet(sets[2].signature, sets[2].pubkeys, msgs[3])
    elif case == "infinity_signature":
        sets[1] = jbls.SignatureSet(jbls.Signature(bytes([0xC0]) + bytes(95)), sets[1].pubkeys,
                                    sets[1].message)
    elif case == "non_subgroup_signature":
        pt = T.non_subgroup_point(9)
        jpt = (jcv.Fq2(pt[0].a, pt[0].b), jcv.Fq2(pt[1].a, pt[1].b))
        sets[4] = jbls.SignatureSet(jbls.Signature(jcv.g2_to_bytes(jpt)), sets[4].pubkeys,
                                    sets[4].message)
    elif case == "identity_aggregate":
        neg = jcv.g1_neg(pks[3].point)
        sets[5] = jbls.SignatureSet(sets[5].signature,
                                    [pks[3], jbls.PublicKey(jcv.g1_to_bytes(neg))] * 9, msgs[5])
    return tuple(sets)


def _carry(jsets):
    return signature_sets_from_bytes(
        ([pk.to_bytes() for pk in s.pubkeys], s.signature.to_bytes(), s.message) for s in jsets)


CASES = [("valid", True, None), ("tampered", False, None), ("infinity_signature", False, None),
         ("non_subgroup_signature", False, None), ("identity_aggregate", False, None),
         ("valid", True, 4)]


@pytest.mark.parametrize("case,expect,chunk", CASES,
                         ids=[c if k is None else f"{c}-two-chunks" for c, _, k in CASES])
def test_verdict_matches_the_jax_reference_backend(case, expect, chunk):
    jsets = _batch(case)
    want = jbls.verify_signature_sets(jsets, backend="reference")
    got = bls.verify_signature_sets(_carry(jsets), backend="cuda", chunk_size=chunk, device="cpu")
    assert got == want == expect


def test_cuda_backend_runs_on_the_card_unless_asked_for_the_cpu():
    sets = _carry(_batch("valid")[:1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bls.verify_signature_sets(sets, backend="cuda")
    assert bb.verify_signature_sets_device([], device="cpu") is False
    with pytest.raises(KeyError):
        bls.verify_signature_sets(sets, backend="tpu")


def test_default_backend_is_the_card_and_never_the_host(monkeypatch):
    """Without a backend named, the batch goes to the card: with no card
    the call raises before any host work, and the host reference backend
    is never reached."""
    if torch.cuda.is_available():
        pytest.skip("checks the call without a card")
    sets = _carry(_batch("valid")[:2])

    def host(*_a, **_k):
        raise AssertionError("the default call reached the host reference backend")

    monkeypatch.setitem(api._BACKENDS, "reference", host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bls.verify_signature_sets(sets)
    assert all(s.signature._point is None for s in sets)     # nothing was decompressed


def test_blinding_and_batch_scalars_come_from_secrets(monkeypatch):
    """Production scalars are unpredictable: a seeded generator would let
    an attacker forge a batch.  Only the test seam takes explicit ones."""
    drawn = []
    real = bb.secrets.randbits

    def spy(k):
        drawn.append(k)
        return real(k)

    monkeypatch.setattr(bb.secrets, "randbits", spy)
    assert bb._nonzero_scalar() > 0
    bb._blinding(len(bb._BLIND_U) + 1)
    assert drawn == [64, 64]
    drawn.clear()
    sets = _carry(_batch("valid")[:2])
    assert bb._verify_sets_pipeline(sets, device=torch.device("cpu"), scalars=[3, 5]) is True
    assert drawn == []


@pytest.mark.slow
@pytest.mark.parametrize("case,expect,chunk", CASES[:5])
def test_verdict_matches_the_jax_tpu_backend(case, expect, chunk):
    jsets = _batch(case)
    want = jbls.verify_signature_sets(jsets, backend="tpu")
    got = bls.verify_signature_sets(_carry(jsets), backend="cuda", device="cpu")
    assert got == want == expect


def test_microbench_and_block_builders_follow_their_sources():
    sets = T.microbench_sets(70)
    assert len(sets) == 70 and len({s.message for s in sets}) == 64
    assert len({s.pubkeys[0].to_bytes() for s in sets}) == 70
    assert sets[64].message == sets[0].message and sets[64].pubkeys[0] is sets[64].pubkeys[0]
    block = T.block_signature_sets(3, 1 << 12)     # committees of 2 at 2^12 validators
    assert len(block) == 131
    assert [len(s.pubkeys) for s in block] == [2] * 128 + [512, 1, 1]
    sync = block[128].pubkeys
    assert len({pk.to_bytes() for pk in sync}) < len(sync)      # sampled with replacement
    att = {pk.to_bytes() for s in block[:128] for pk in s.pubkeys}
    assert len(att) == 256                                       # all members distinct
    assert bls.verify_signature_sets(block[128:130], backend="reference")
