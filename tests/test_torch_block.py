"""The port's Deneb block processing against the JAX package's, on the CPU.

Both packages process the same blocks, made by the JAX package's
``Harness(64, fork="deneb")`` at the minimal preset and carried into the
port by SSZ (states and blocks), and must give the same post-state roots,
the same signature sets (messages, key bytes, signature bytes) and the same
``BlockProcessingError`` messages.  The long run (fake signatures,
NO_VERIFICATION in both) crosses epoch boundaries and a sync-committee
period boundary; each operation (proposer and attester slashings, a deposit
with its proof, an exit, a BLS-to-execution change, a withdrawals sweep)
runs alone in a block; the committee shuffle from the chain's cache equals
a fresh one for every block.  Two real-signature blocks verify with
VERIFY_BULK in both packages (the JAX side on its reference backend).
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from lighthouse_tpu import types as JT
from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.ssz.merkle_proof import MerkleTree as JaxMerkleTree
from lighthouse_tpu.state_transition import block_processing as jbp
from lighthouse_tpu.state_transition import misc as jmisc
from lighthouse_tpu.state_transition import signature_sets as jsigs
from lighthouse_tpu.state_transition import state_advance as jadvance
from lighthouse_tpu.state_transition import state_transition as jtransition
from lighthouse_tpu.testing import Harness
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.crypto.bls import api as pbls
from lighthouse_tpu_torch.state_transition import (
    BlockProcessingError,
    SignatureStrategy,
    misc,
    process_block,
    state_advance,
    state_transition,
)
from lighthouse_tpu_torch.state_transition import block_processing as bp
from lighthouse_tpu_torch.state_transition import signature_sets as sigs
from lighthouse_tpu_torch import types as PT
from lighthouse_tpu_torch.types import ChainSpec, DepositMessage, make_types
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")

CPU = "cpu"
SPEC = ChainSpec.minimal().with_forks_at(0, "deneb")
TYPES = make_types(SPEC.preset)
JNONE = jbp.SignatureStrategy.NO_VERIFICATION
NONE = SignatureStrategy.NO_VERIFICATION


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_backend():
    """The JAX side verifies on its host reference backend (no XLA BLS
    program compiles), restored afterwards."""
    old = jbls.get_backend()
    jbls.set_backend("reference")
    yield
    jbls.set_backend(old)


def _port_block(signed):
    return TYPES.SignedBeaconBlockDeneb.deserialize(signed.serialize())


def _port_state(jstate):
    return state_from_ssz(jstate.serialize())


def _set_view(sets) -> list:
    return [(bytes(s.message), [pk.to_bytes() for pk in s.pubkeys], s.signature.to_bytes())
            for s in sets]


def _jax_error(fn) -> str:
    with pytest.raises(jbp.BlockProcessingError) as e:
        fn()
    return str(e.value)


def _port_error(fn) -> str:
    with pytest.raises(BlockProcessingError) as e:
        fn()
    return str(e.value)


# --- containers --------------------------------------------------------------

def test_containers_round_trip_byte_for_byte():
    h = Harness(64, fork="deneb", real_crypto=False)
    signed = h.produce_block(attestations=[])
    raw = signed.serialize()
    ours = _port_block(signed)
    assert ours.serialize() == raw
    assert ours.message.hash_tree_root(CPU) == signed.message.hash_tree_root()
    assert TYPES.decode_signed_block(raw).serialize() == raw
    header = JT.BeaconBlockHeader(slot=3, proposer_index=5, parent_root=b"\x01" * 32,
                                  state_root=b"\x02" * 32, body_root=b"\x03" * 32)
    ops = [
        JT.ProposerSlashing(
            signed_header_1=JT.SignedBeaconBlockHeader(message=header, signature=b"\x04" * 96),
            signed_header_2=JT.SignedBeaconBlockHeader(message=header, signature=b"\x05" * 96)),
        JT.Deposit(proof=[bytes([i]) * 32 for i in range(33)],
                   data=JT.DepositData(pubkey=b"\x06" * 48, withdrawal_credentials=b"\x07" * 32,
                                       amount=32 * 10**9, signature=b"\x08" * 96)),
        JT.SignedVoluntaryExit(message=JT.VoluntaryExit(epoch=4, validator_index=9),
                               signature=b"\x09" * 96),
        JT.SignedBLSToExecutionChange(
            message=JT.BLSToExecutionChange(validator_index=2, from_bls_pubkey=b"\x0a" * 48,
                                            to_execution_address=b"\x0b" * 20),
            signature=b"\x0c" * 96),
        JT.Withdrawal(index=7, validator_index=8, address=b"\x0d" * 20, amount=123),
        h.t.AttesterSlashing(attestation_1=h.t.IndexedAttestation(
            attesting_indices=np.array([1, 4, 9], np.uint64),
            data=JT.AttestationData(slot=2, index=0, beacon_block_root=b"\x0e" * 32,
                                    source=JT.Checkpoint(epoch=0, root=b"\x0f" * 32),
                                    target=JT.Checkpoint(epoch=0, root=b"\x10" * 32)),
            signature=b"\x11" * 96)),
        h.t.SyncAggregate(sync_committee_bits=[i % 3 == 0 for i in range(32)],
                          sync_committee_signature=b"\x12" * 96),
    ]
    for op in ops:
        cls = getattr(TYPES, type(op).__name__, None) or getattr(PT, type(op).__name__)
        ours = cls.deserialize(op.serialize())
        assert ours.serialize() == op.serialize(), type(op).__name__
        assert ours.hash_tree_root(CPU) == op.hash_tree_root(), type(op).__name__


# --- the long run ---------------------------------------------------------------

def test_blocks_give_the_jax_roots_sets_and_shuffles_across_boundaries():
    """70 blocks with attestations from genesis: epoch boundaries every 8
    slots and the sync-committee period boundary at slot 64."""
    h = Harness(64, fork="deneb", real_crypto=False)
    state = _port_state(h.state)
    chain = BeaconChain(SPEC, _port_state(h.state), bls_backend="reference", device=CPU)
    period_slots = SPEC.preset.epochs_per_sync_committee_period * SPEC.preset.slots_per_epoch
    for i in range(period_slots + 6):
        atts = [h.attest()] if int(h.state.slot) > 0 else []
        signed = h.produce_block(attestations=atts)
        block = _port_block(signed)
        pre_j = h.state.copy()
        jadvance(pre_j, h.spec, int(signed.message.slot))
        jtransition(h.state, h.spec, signed, JNONE)
        pre = state.copy()
        state_advance(pre, SPEC, int(block.message.slot), CPU)
        # the sets of the block, and the cached shuffle against a fresh one
        assert _set_view(sigs.include_all_signatures(
            pre, SPEC, block, shuffle_fn=chain.committee_shuffle, device=CPU)) == \
            _set_view(jsigs.include_all_signatures(pre_j, h.spec, signed))
        for att in block.message.body.attestations:
            epoch = int(att.data.target.epoch)
            assert np.array_equal(chain.committee_shuffle(pre, epoch),
                                  misc.compute_committee_shuffle(pre, SPEC, epoch, device=CPU))
        state_transition(state, SPEC, block, NONE, device=CPU,
                         shuffle_fn=chain.committee_shuffle)
        assert state.hash_tree_root(CPU) == h.state.hash_tree_root(), f"block {i}"
    assert int(state.slot) > period_slots
    assert state.current_sync_committee == _port_state(h.state).current_sync_committee


# --- one operation at a time ---------------------------------------------------

def _world(spec=None):
    h = Harness(64, spec=spec, fork="deneb", real_crypto=False)
    h.extend_chain(2)
    return h


def _apply_both(h, edit_state=None, **body):
    """A block at the next slot with ``body`` fields replaced, processed
    with NO_VERIFICATION by both packages -> (JAX root, port root, JAX
    error, port error); ``edit_state(state)`` edits the parent state after
    the block is made (applied to the JAX state, carried to the port by
    SSZ)."""
    signed = h.produce_block(attestations=body.pop("attestations", []))
    if edit_state is not None:
        edit_state(h.state)
    pre_port = _port_state(h.state)
    for k, v in body.items():
        setattr(signed.message.body, k, v)
    trial = h.state.copy()
    jadvance(trial, h.spec, int(signed.message.slot))
    if edit_state is not None:       # the edit changed the parent's root
        signed.message.parent_root = trial.latest_block_header.hash_tree_root()
    pre_j = trial.copy()
    try:
        jbp.process_block(trial, h.spec, signed, JNONE)
        signed.message.state_root = trial.hash_tree_root()
        jerr = None
    except jbp.BlockProcessingError as e:
        jerr = str(e)
    block = _port_block(signed)
    port_spec = dataclasses.replace(SPEC, shard_committee_period=h.spec.shard_committee_period)
    pre = pre_port.copy()
    state_advance(pre, port_spec, int(block.message.slot), CPU)
    sets_j = jsigs.include_all_signatures(pre_j, h.spec, signed)
    sets_p = sigs.include_all_signatures(pre, port_spec, block, device=CPU)
    assert _set_view(sets_p) == _set_view(sets_j)
    perr = None
    try:
        process_block(pre, port_spec, block, NONE, device=CPU)
    except BlockProcessingError as e:
        perr = str(e)
    jroot = None if jerr else trial.hash_tree_root()
    proot = None if perr else pre.hash_tree_root(CPU)
    return jroot, proot, jerr, perr


def test_proposer_slashing_matches_jax():
    h = _world()
    slot = int(h.state.slot) - 1
    hdr = [JT.BeaconBlockHeader(slot=slot, proposer_index=5, parent_root=b"\x01" * 32,
                                state_root=b"\x02" * 32, body_root=bytes([k]) * 32) for k in (3, 4)]
    ps = JT.ProposerSlashing(
        signed_header_1=JT.SignedBeaconBlockHeader(message=hdr[0], signature=b"\x05" * 96),
        signed_header_2=JT.SignedBeaconBlockHeader(message=hdr[1], signature=b"\x06" * 96))
    jroot, proot, jerr, perr = _apply_both(h, proposer_slashings=[ps])
    assert jerr is None and perr is None and jroot == proot
    # the same header twice is no slashing, in both
    same = JT.ProposerSlashing(signed_header_1=ps.signed_header_1,
                               signed_header_2=ps.signed_header_1)
    _, _, jerr, perr = _apply_both(_world(), proposer_slashings=[same])
    assert jerr == perr == "proposer slashing: headers identical"


def test_attester_slashing_matches_jax():
    h = _world()
    data = [JT.AttestationData(slot=1, index=0, beacon_block_root=bytes([k]) * 32,
                               source=JT.Checkpoint(epoch=0, root=b"\x00" * 32),
                               target=JT.Checkpoint(epoch=0, root=b"\x07" * 32)) for k in (1, 2)]
    ia = [h.t.IndexedAttestation(attesting_indices=np.array(ix, np.uint64), data=d,
                                 signature=b"\x08" * 96)
          for ix, d in (([3, 7, 9], data[0]), ([7, 9, 12], data[1]))]
    asl = h.t.AttesterSlashing(attestation_1=ia[0], attestation_2=ia[1])
    jroot, proot, jerr, perr = _apply_both(h, attester_slashings=[asl])
    assert jerr is None and perr is None and jroot == proot


def test_deposit_with_its_proof_matches_jax():
    h = _world()
    sk = pbls.SecretKey(0x1234567)
    pk = sk.public_key().to_bytes()
    creds = b"\x00" + hashlib.sha256(pk).digest()[1:]
    amount = 32 * 10**9
    domain = misc.compute_domain(SPEC.domain_deposit, SPEC.genesis_fork_version, b"\x00" * 32)
    msg = DepositMessage(pubkey=pk, withdrawal_credentials=creds, amount=amount)
    sig = sk.sign(misc.compute_signing_root(msg.hash_tree_root(CPU), domain)).to_bytes()
    data = JT.DepositData(pubkey=pk, withdrawal_credentials=creds, amount=amount, signature=sig)
    index = int(h.state.eth1_deposit_index)
    leaves = [hashlib.sha256(i.to_bytes(8, "little")).digest() for i in range(index)]
    tree = JaxMerkleTree.create(leaves + [data.hash_tree_root()], 32)
    _leaf, branch = tree.generate_proof(index)
    count = index + 1
    root = hashlib.sha256(tree.root() + count.to_bytes(32, "little")).digest()
    proof = branch + [count.to_bytes(32, "little")]
    assert misc.is_valid_merkle_branch(data.hash_tree_root(), proof, 33, index, root)
    assert not misc.is_valid_merkle_branch(data.hash_tree_root(), proof, 33, index + 1, root)

    def eth1(state):
        state.eth1_data = JT.Eth1Data(deposit_root=root, deposit_count=count,
                                      block_hash=b"\x33" * 32)

    dep = JT.Deposit(proof=proof, data=data)
    jroot, proot, jerr, perr = _apply_both(h, edit_state=eth1, deposits=[dep])
    assert jerr is None and perr is None and jroot == proot
    # a bad proof gives the JAX error
    bad = JT.Deposit(proof=[b"\x00" * 32] * 33, data=data)
    h2 = _world()
    _, _, jerr, perr = _apply_both(h2, edit_state=eth1, deposits=[bad])
    assert jerr == perr == "invalid deposit merkle proof"


def test_exit_and_bls_change_match_jax():
    spec = dataclasses.replace(JT.ChainSpec.minimal().with_forks_at(0, "deneb"),
                               shard_committee_period=0)
    h = _world(spec)
    epoch = jmisc.current_epoch(h.state, h.spec)
    ex = JT.SignedVoluntaryExit(message=JT.VoluntaryExit(epoch=epoch, validator_index=9),
                                signature=b"\x09" * 96)
    pk = h.state.validators.pubkeys[11].tobytes()
    change = JT.SignedBLSToExecutionChange(
        message=JT.BLSToExecutionChange(validator_index=11, from_bls_pubkey=pk,
                                        to_execution_address=b"\x0b" * 20),
        signature=b"\x0c" * 96)
    jroot, proot, jerr, perr = _apply_both(h, voluntary_exits=[ex],
                                           bls_to_execution_changes=[change])
    assert jerr is None and perr is None and jroot == proot
    wrong = JT.SignedBLSToExecutionChange(
        message=JT.BLSToExecutionChange(validator_index=12, from_bls_pubkey=pk,
                                        to_execution_address=b"\x0b" * 20),
        signature=b"\x0c" * 96)
    _, _, jerr, perr = _apply_both(_world(spec), bls_to_execution_changes=[wrong])
    assert jerr == perr == "bls change: pubkey hash mismatch"


def test_withdrawal_sweep_matches_jax():
    def eligible(state):
        v = state.validators
        for i in list(range(0, 64, 3)) + [62, 63]:
            v.withdrawal_credentials[i, 0] = 0x01
            state.balances[i] = np.uint64(33 * 10**9 + i)
        v.withdrawable_epoch[63] = 0                       # one full withdrawal
        state.next_withdrawal_validator_index = 60         # the sweep wraps
    h = _world()
    eligible(h.state)
    pre_j = h.state.copy()
    jadvance(pre_j, h.spec, int(h.state.slot) + 1)
    pre = _port_state(pre_j)
    want = jbp.get_expected_withdrawals(pre_j, h.spec)
    got = bp.get_expected_withdrawals(pre, SPEC)
    assert [w.serialize() for w in got] == [w.serialize() for w in want] and want
    jroot, proot, jerr, perr = _apply_both(h)
    assert jerr is None and perr is None and jroot == proot


def test_tampered_blocks_give_the_jax_errors():
    cases = {
        "proposer_index": lambda b: setattr(b.message, "proposer_index",
                                            (int(b.message.proposer_index) + 1) % 64),
        "parent_root": lambda b: setattr(b.message, "parent_root", b"\x05" * 32),
        "payload_parent": lambda b: setattr(b.message.body.execution_payload, "parent_hash",
                                            b"\x06" * 32),
        "timestamp": lambda b: setattr(b.message.body.execution_payload, "timestamp", 7),
        "withdrawals": lambda b: setattr(b.message.body.execution_payload, "withdrawals", [
            JT.Withdrawal(index=0, validator_index=1, address=b"\x00" * 20, amount=1)]),
        "attestation_source": lambda b: setattr(b.message.body.attestations[0].data.source,
                                                "root", b"\x07" * 32),
        "deposits": lambda b: setattr(b.message.body, "deposits", [JT.Deposit()]),
        "sync_aggregate": lambda b: setattr(b.message.body, "sync_aggregate", h.t.SyncAggregate(
            sync_committee_bits=[False] * 32, sync_committee_signature=b"\xab" * 96)),
    }
    h = _world()
    base = h.state.copy()
    for name, edit in cases.items():
        h.state = base.copy()
        signed = h.produce_block(attestations=[h.attest()])
        edit(signed)
        strategy = jbp.SignatureStrategy.VERIFY_BULK if name == "sync_aggregate" else JNONE
        pstrategy = SignatureStrategy.VERIFY_BULK if name == "sync_aggregate" else NONE
        pre_j = h.state.copy()
        jadvance(pre_j, h.spec, int(signed.message.slot))
        pre = _port_state(pre_j)
        jerr = _jax_error(lambda: jbp.process_block(pre_j, h.spec, signed, strategy))
        perr = _port_error(lambda: process_block(pre, SPEC, _port_block(signed), pstrategy,
                                                 device=CPU, bls_backend="reference"))
        assert perr == jerr, name


# --- real signatures ---------------------------------------------------------------

def test_real_signature_blocks_verify_in_both():
    """Two blocks with real interop signatures: the same sets, VERIFY_BULK
    passes and gives the JAX root; a swapped signature fails in both."""
    h = Harness(64, fork="deneb", real_crypto=True)
    for i in range(2):
        atts = [h.attest()] if int(h.state.slot) > 0 else []
        signed = h.produce_block(attestations=atts)
        pre_j = h.state.copy()
        jadvance(pre_j, h.spec, int(signed.message.slot))
        pre = _port_state(pre_j)
        block = _port_block(signed)
        assert _set_view(sigs.include_all_signatures(pre, SPEC, block, device=CPU)) == \
            _set_view(jsigs.include_all_signatures(pre_j, h.spec, signed))
        if i == 1:
            bad = _port_block(signed)
            body = bad.message.body
            body.randao_reveal, bad.signature = bad.signature, body.randao_reveal
            bad_j = h.t.SignedBeaconBlockDeneb.deserialize(bad.serialize())
            jerr = _jax_error(lambda: jbp.process_block(pre_j.copy(), h.spec, bad_j))
            perr = _port_error(lambda: process_block(pre.copy(), SPEC, bad,
                                                     SignatureStrategy.VERIFY_BULK,
                                                     device=CPU, bls_backend="cuda"))
            assert perr == jerr == "bulk signature verification failed"
        process_block(pre, SPEC, block, SignatureStrategy.VERIFY_BULK, device=CPU,
                      bls_backend="cuda")
        jtransition(h.state, h.spec, signed)
        assert pre.hash_tree_root(CPU) == bytes(signed.message.state_root) == \
            h.state.hash_tree_root()
