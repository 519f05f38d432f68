"""The port's blob path (``chain/blob_verification.py``,
``chain/data_availability.py`` and ``BeaconChain``'s availability gate and
``process_gossip_blob``) against the JAX package's, on the CPU.

A minimal Deneb preset with 16 field elements a blob (``tests/test_blobs.py``
builds the same one).  Inclusion proofs are compared byte for byte, the
availability checker case by case, and chains of 32 validators anchored at
the same genesis state (the port's carried over by SSZ) import the same
blocks with 1, 3 and 6 blobs in both arrival orders: equal block roots,
post-state roots, heads, fork-choice nodes, kept blob data and
``BlobError`` reasons.

KZG: the blobs, commitments and proofs come from the port's
``KzgSettings.dev(16)`` (``tests/test_torch_kzg.py`` holds them to the JAX
package's).  Both chains' ``validate_blobs`` answer from one oracle: the
port's own verifier, run for real (one batch of the six blobs, 2 s on the
CPU, then one call for any other input).  The JAX verifier's first call
compiles for about a minute on the CPU, so the chains share the port's
verdicts; their flows, checks and reasons are what is compared.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from lighthouse_tpu import types as JT
from lighthouse_tpu.chain import blob_verification as jbv
from lighthouse_tpu.chain.beacon_chain import BeaconChain as JaxChain
from lighthouse_tpu.chain.data_availability import DataAvailabilityChecker as JaxDA
from lighthouse_tpu.state_transition import SignatureStrategy, state_transition
from lighthouse_tpu.testing import Harness
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.chain import blob_verification as pbv
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
from lighthouse_tpu_torch.chain.data_availability import DataAvailabilityChecker
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.types import ChainSpec, make_types

CPU = "cpu"
WIDTH = 16
N_VALIDATORS = 32
_JBASE = JT.ChainSpec.minimal().with_forks_at(0, through="deneb")
JSPEC = dataclasses.replace(
    _JBASE, preset=dataclasses.replace(_JBASE.preset, field_elements_per_blob=WIDTH))
_PBASE = ChainSpec.minimal().with_forks_at(0, "deneb")
PSPEC = dataclasses.replace(
    _PBASE, preset=dataclasses.replace(_PBASE.preset, field_elements_per_blob=WIDTH))
JTYPES = JT.make_types(JSPEC.preset)
PTYPES = make_types(PSPEC.preset)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def blob_data():
    """Six blobs of width 16 with their commitments and proofs on the
    port's dev setup, the six verified in one real batch."""
    settings = kzg.KzgSettings.dev(WIDTH, device=CPU)
    rng = np.random.default_rng(15)
    blobs = [T.kzg_blob(WIDTH, rng) for _ in range(6)]
    commitments = [kzg.blob_to_kzg_commitment(b, settings, CPU) for b in blobs]
    proofs = [kzg.compute_blob_kzg_proof(b, c, settings, CPU) for b, c in zip(blobs, commitments)]
    assert pbv.validate_blobs(settings, commitments, blobs, proofs, CPU)
    return dict(settings=settings, blobs=blobs, commitments=commitments, proofs=proofs,
                verified={(c, b, p) for c, b, p in zip(commitments, blobs, proofs)})


@pytest.fixture(scope="module")
def harness():
    """The JAX harness of 32 validators at genesis (its keys take about a
    second to derive); each test takes a deep copy."""
    return Harness(N_VALIDATORS, spec=JSPEC, fork="deneb", real_crypto=False)


@pytest.fixture
def kzg_oracle(monkeypatch, blob_data):
    """Both packages' ``validate_blobs`` answer with the port's verifier:
    True for blobs of the verified batch, a real call (once for each input)
    for anything else.  Returns the list of real calls' verdicts."""
    real = pbv.validate_blobs
    calls, memo = [], {}

    def oracle(settings, commitments, blobs, proofs, device=None):
        triples = tuple((bytes(c), bytes(b), bytes(p))
                        for c, b, p in zip(commitments, blobs, proofs))
        if set(triples) <= blob_data["verified"]:
            return True
        if triples not in memo:
            memo[triples] = real(blob_data["settings"], commitments, blobs, proofs, CPU)
            calls.append(memo[triples])
        return memo[triples]

    monkeypatch.setattr(pbv, "validate_blobs", oracle)
    monkeypatch.setattr(jbv, "validate_blobs", oracle)
    return calls


def _chains(h):
    j = JaxChain(JSPEC, h.state.copy(), verify_signatures=False, kzg_settings=None)
    p = BeaconChain(PSPEC, state_from_ssz(h.state.serialize()), bls_backend="reference",
                    device=CPU, verify_signatures=False, kzg_settings=None)
    assert p.anchor_root == j.genesis_block_root
    return j, p


def _port_block(signed):
    return PTYPES.SignedBeaconBlockDeneb.deserialize(signed.serialize())


def _port_sidecar(sidecar):
    return PTYPES.BlobSidecar.deserialize(sidecar.serialize())


def _jax_node(c, root) -> dict:
    pa = c.fork_choice.proto
    i = pa.indices[root]
    parent = int(pa.parents[i])
    return dict(parent=pa.roots[parent] if parent >= 0 else None, slot=int(pa.slots[i]),
                justified_epoch=int(pa.justified_epoch[i]),
                finalized_epoch=int(pa.finalized_epoch[i]),
                unrealized_justified_epoch=int(pa.unrealized_justified_epoch[i]),
                unrealized_finalized_epoch=int(pa.unrealized_finalized_epoch[i]),
                justified_root=pa.justified_roots[i])


def _port_node(c, root) -> dict:
    node = c.fork_choice.proto.node(root)
    return {k: node[k] for k in ("parent", "slot", "justified_epoch", "finalized_epoch",
                                 "unrealized_justified_epoch", "unrealized_finalized_epoch",
                                 "justified_root")}


def _blob_block(h, blob_data, n: int):
    """A block of the harness's next slot with the first n blobs, and its
    sidecars (JAX objects)."""
    commitments = blob_data["commitments"][:n]
    signed = h.produce_block(blob_commitments=commitments)
    sidecars = h.make_blob_sidecars(signed, blob_data["blobs"][:n], blob_data["proofs"][:n])
    return signed, sidecars


def _both(j, p, fn_j, fn_p, err_j=jbv.BlobError, err_p=pbv.BlobError):
    """[JAX result or reason, port result or reason]."""
    out = []
    for fn, err in ((fn_j, err_j), (fn_p, err_p)):
        try:
            out.append(fn())
        except err as e:
            out.append(e.reason)
    return out


# --------------------------------------------------------------------------
# inclusion proofs
# --------------------------------------------------------------------------

def _body(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return JTYPES.BeaconBlockBodyDeneb(
        randao_reveal=rng.bytes(96), graffiti=rng.bytes(32),
        blob_kzg_commitments=[rng.bytes(48) for _ in range(n)])


def _sidecar(types, body, index: int, commitment: bytes, proof: list, header_cls, signed_cls):
    header = header_cls(slot=5, proposer_index=0, parent_root=b"\x11" * 32,
                        state_root=b"\x22" * 32, body_root=body.hash_tree_root(
                            *(() if types is JTYPES else (CPU,))))
    return types.BlobSidecar(index=index, blob=b"\x00" * (WIDTH * 32), kzg_commitment=commitment,
                             kzg_proof=b"\x00" * 48,
                             signed_block_header=signed_cls(message=header, signature=b"\x00" * 96),
                             kzg_commitment_inclusion_proof=proof)


@pytest.mark.parametrize("n", range(1, 7))
def test_inclusion_proofs_equal_jax_and_verify_alike(n):
    """Every index's branch byte for byte; both verifiers take it, and both
    refuse a changed commitment, index or branch node."""
    from lighthouse_tpu.types.containers import BeaconBlockHeader as JH
    from lighthouse_tpu.types.containers import SignedBeaconBlockHeader as JSH
    from lighthouse_tpu_torch.types import BeaconBlockHeader as PH
    from lighthouse_tpu_torch.types import SignedBeaconBlockHeader as PSH

    jbody = _body(n, seed=n)
    pbody = PTYPES.BeaconBlockBodyDeneb.deserialize(jbody.serialize())
    assert pbody.hash_tree_root(CPU) == jbody.hash_tree_root()
    for index in range(n):
        jproof = jbv.compute_kzg_inclusion_proof(jbody, index, JSPEC)
        pproof = pbv.compute_kzg_inclusion_proof(pbody, index, PSPEC, CPU)
        assert [bytes(x) for x in pproof] == [bytes(x) for x in jproof]
        assert len(pproof) == 17
        commitment = bytes(jbody.blob_kzg_commitments[index])
        other = bytes(b ^ 0xFF for b in commitment)
        bad_branch = list(pproof)
        bad_branch[index % len(bad_branch)] = b"\x5a" * 32
        cases = [(index, commitment, pproof, True), (index, other, pproof, False),
                 ((index + 1) % 6 if n > 1 else index + 1, commitment, pproof, False),
                 (index, commitment, bad_branch, False)]
        for idx, c, proof, want in cases:
            js = _sidecar(JTYPES, jbody, idx, c, proof, JH, JSH)
            ps = _sidecar(PTYPES, pbody, idx, c, proof, PH, PSH)
            assert ps.serialize() == js.serialize()
            assert jbv.verify_kzg_inclusion_proof(js, JSPEC) is want
            assert pbv.verify_kzg_inclusion_proof(ps, PSPEC) is want


# --------------------------------------------------------------------------
# the availability checker (the cases of tests/test_blobs.py TestDataAvailability)
# --------------------------------------------------------------------------

def _da_block(n: int, slot: int = 3):
    body = JTYPES.BeaconBlockBodyDeneb(blob_kzg_commitments=[bytes([i]) * 48 for i in range(n)])
    block = JTYPES.BeaconBlockDeneb(slot=slot, proposer_index=0, parent_root=b"\x00" * 32,
                                    state_root=b"\x00" * 32, body=body)
    return JTYPES.SignedBeaconBlockDeneb(message=block, signature=b"\x00" * 96)


def _da_sidecar(index: int):
    from lighthouse_tpu.types.containers import BeaconBlockHeader as JH
    from lighthouse_tpu.types.containers import SignedBeaconBlockHeader as JSH

    header = JH(slot=3, proposer_index=0, parent_root=b"\x00" * 32, state_root=b"\x00" * 32,
                body_root=b"\x00" * 32)
    return JTYPES.BlobSidecar(index=index, blob=b"\x00" * (WIDTH * 32),
                              kzg_commitment=bytes([index]) * 48, kzg_proof=b"\x00" * 48,
                              signed_block_header=JSH(message=header, signature=b"\x00" * 96),
                              kzg_commitment_inclusion_proof=[b"\x00" * 32] * 17)


def _da_run(case: str, checker, block, sidecar) -> list:
    """One case's observable outcomes on a checker."""
    out = []

    def avail(a):
        return (a.is_available, None if a.blobs is None else [int(s.index) for s in a.blobs])

    if case == "block_then_blobs":
        root = b"\xaa" * 32
        out.append(avail(checker.put_pending_executed_block(root, block(2))))
        out.append(checker.missing_blob_indices(root))
        out.append(checker.has_block(root))
        out.append(avail(checker.put_verified_blobs(root, [sidecar(0)])))
        out.append(checker.missing_blob_indices(root))
        out.append(avail(checker.put_verified_blobs(root, [sidecar(1)])))
        out.append(len(checker))
    elif case == "blobs_then_block":
        root = b"\xbb" * 32
        out.append(avail(checker.put_verified_blobs(root, [sidecar(i) for i in (1, 0)])))
        out.append(checker.missing_blob_indices(root))
        out.append(avail(checker.put_pending_executed_block(root, block(2))))
        out.append(len(checker))
    elif case == "zero_commitments":
        out.append(avail(checker.put_pending_executed_block(b"\xcc" * 32, block(0))))
    elif case == "capacity_eviction":
        checker.capacity = 2
        for i in range(3):
            checker.put_verified_blobs(bytes([i]) * 32, [sidecar(0)])
        checker.put_verified_blobs(bytes([1]) * 32, [sidecar(1)])     # 1 most recent
        checker.put_verified_blobs(bytes([3]) * 32, [sidecar(0)])
        out.append(len(checker))
        out.append(sorted(checker._pending))
    elif case == "prune_finalized":
        checker.put_pending_executed_block(b"\xdd" * 32, block(1, slot=3))
        checker.put_pending_executed_block(b"\xee" * 32, block(1, slot=9))
        checker.prune_finalized(8)
        out.append(sorted(checker._pending))
    return out


@pytest.mark.parametrize("case", ["block_then_blobs", "blobs_then_block", "zero_commitments",
                                  "capacity_eviction", "prune_finalized"])
def test_availability_checker_matches_jax(case):
    want = _da_run(case, JaxDA(JSPEC), _da_block, _da_sidecar)
    got = _da_run(case, DataAvailabilityChecker(PSPEC),
                  lambda *a, **k: _port_block(_da_block(*a, **k)),
                  lambda i: _port_sidecar(_da_sidecar(i)))
    assert got == want
    assert want    # the case observed something


# --------------------------------------------------------------------------
# chains
# --------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["block_first", "sidecars_first"])
@pytest.mark.parametrize("n_blobs", [1, 3, 6])
def test_chains_import_blob_blocks_as_the_jax_chain_does(harness, kzg_oracle, blob_data,
                                                         n_blobs, order):
    """A block with n blobs, then a child without blobs: the same returns
    at each arrival, the same roots, post-state roots, heads, fork-choice
    nodes and kept blob data."""
    h = copy.deepcopy(harness)
    j, p = _chains(h)
    signed, sidecars = _blob_block(h, blob_data, n_blobs)
    state_transition(h.state, h.spec, signed, SignatureStrategy.NO_VERIFICATION)
    child = h.produce_block()
    slot = int(signed.message.slot)
    for c in (j, p):
        c.slot_clock.set_slot(slot)
    root = signed.message.hash_tree_root()
    if order == "block_first":
        assert _both(j, p, lambda: j.process_block(signed),
                     lambda: p.process_block(_port_block(signed))) == [None, None]
        assert p.da_checker.missing_blob_indices(root) == \
            j.da_checker.missing_blob_indices(root) == list(range(n_blobs))
    got = []
    for sc in sidecars:
        got.append(_both(j, p, lambda: j.process_gossip_blob(sc),
                         lambda: p.process_gossip_blob(_port_sidecar(sc))))
    if order == "block_first":
        assert got == [[None, None]] * (n_blobs - 1) + [[root, root]]
    else:
        assert got == [[None, None]] * n_blobs
        assert p.da_checker.missing_blob_indices(root) is None
        assert _both(j, p, lambda: j.process_block(signed),
                     lambda: p.process_block(_port_block(signed))) == [root, root]
    assert kzg_oracle == []                        # every verdict from the verified batch
    assert p.state_for_block(root).hash_tree_root(CPU) == bytes(signed.message.state_root)
    assert _port_node(p, root) == _jax_node(j, root)
    assert p.head_root == j.head_root == root
    assert p.get_blobs(root) == j.store.get_blobs(root) == b"".join(
        _port_sidecar(s).serialize() for s in sidecars)
    assert len(p.da_checker) == len(j.da_checker) == 0
    assert len(p._pending_executed) == len(j._pending_executed) == 0
    # a repeated sidecar of the imported block is a duplicate in both
    assert _both(j, p, lambda: j.process_gossip_blob(sidecars[0]),
                 lambda: p.process_gossip_blob(_port_sidecar(sidecars[0]))) == ["repeat_blob"] * 2
    # the child, without blobs, imports at once in both
    for c in (j, p):
        c.slot_clock.set_slot(int(child.message.slot))
    croot = child.message.hash_tree_root()
    assert _both(j, p, lambda: j.process_block(child),
                 lambda: p.process_block(_port_block(child))) == [croot, croot]
    assert _port_node(p, croot) == _jax_node(j, croot)
    assert p.head_root == j.head_root == croot
    assert p.get_blobs(croot) is None and j.store.get_blobs(croot) is None


def _tamper(kind: str, sidecars):
    sc = copy.deepcopy(sidecars[0])
    header = sc.signed_block_header.message
    if kind == "invalid_kzg_proof":
        sc.kzg_proof = bytes(sidecars[1].kzg_proof)
    elif kind == "invalid_subnet_index":
        sc.index = JSPEC.preset.max_blobs_per_block
    elif kind == "invalid_inclusion_proof/index":
        sc.index = 1
    elif kind == "invalid_inclusion_proof/branch":
        proof = list(sc.kzg_commitment_inclusion_proof)
        proof[3] = b"\x5a" * 32
        sc.kzg_commitment_inclusion_proof = proof
    elif kind == "invalid_proposer":
        header.proposer_index = (int(header.proposer_index) + 1) % N_VALIDATORS
    elif kind == "future_slot":
        header.slot = int(header.slot) + 5
    elif kind == "unknown_parent":
        header.parent_root = b"\x12" * 32
    return sc


@pytest.mark.parametrize("kind", ["invalid_kzg_proof", "invalid_subnet_index",
                                  "invalid_inclusion_proof/index",
                                  "invalid_inclusion_proof/branch", "invalid_proposer",
                                  "future_slot", "unknown_parent"])
def test_tampered_sidecars_give_the_jax_reasons(harness, kzg_oracle, blob_data, kind):
    """A tampered copy of a block's first sidecar: the same BlobError reason
    in both chains; it marks nothing, so the honest sidecars still import
    the block."""
    h = copy.deepcopy(harness)
    j, p = _chains(h)
    signed, sidecars = _blob_block(h, blob_data, 2)
    for c in (j, p):
        c.slot_clock.set_slot(int(signed.message.slot))
    assert _both(j, p, lambda: j.process_block(signed),
                 lambda: p.process_block(_port_block(signed))) == [None, None]
    bad = _tamper(kind, sidecars)
    want = kind.split("/")[0]
    assert _both(j, p, lambda: j.process_gossip_blob(bad),
                 lambda: p.process_gossip_blob(_port_sidecar(bad))) == [want, want]
    assert kzg_oracle == ([False] if kind == "invalid_kzg_proof" else [])
    root = signed.message.hash_tree_root()
    got = [_both(j, p, lambda: j.process_gossip_blob(sc),
                 lambda: p.process_gossip_blob(_port_sidecar(sc))) for sc in sidecars]
    assert got == [[None, None], [root, root]]


def test_a_copy_that_commits_first_wins_in_both(harness, kzg_oracle, blob_data, monkeypatch):
    """Two copies of a sidecar race: while this copy's KZG check runs
    outside the lock, another copy commits (its mark lands first).  This
    copy then returns None and feeds nothing to the checker, in both
    chains."""
    h = copy.deepcopy(harness)
    j, p = _chains(h)
    signed, sidecars = _blob_block(h, blob_data, 2)
    for c in (j, p):
        c.slot_clock.set_slot(int(signed.message.slot))
    root = signed.message.hash_tree_root()
    digest = root + (0).to_bytes(8, "little")
    epoch = JSPEC.compute_epoch_at_slot(int(signed.message.slot))
    oracle_j, oracle_p = jbv.validate_blobs, pbv.validate_blobs

    def racing(chain, oracle):
        def validate(*args, **kwargs):
            chain.observed_blob_sidecars.observe(epoch, digest)
            return oracle(*args, **kwargs)
        return validate

    monkeypatch.setattr(jbv, "validate_blobs", racing(j, oracle_j))
    monkeypatch.setattr(pbv, "validate_blobs", racing(p, oracle_p))
    assert _both(j, p, lambda: j.process_gossip_blob(sidecars[0]),
                 lambda: p.process_gossip_blob(_port_sidecar(sidecars[0]))) == [None, None]
    assert len(j.da_checker) == len(p.da_checker) == 0
