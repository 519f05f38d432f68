"""The containers of a Deneb beacon state, its blocks and their
operations, and its gossip attestations, parameterized by preset.

Port of the Deneb slice of ``lighthouse_tpu/types/containers.py``
(:79-148 and ``make_types`` :226-700, ``BlobSidecar`` :634 among them); other forks' blocks are not ported
(``beacon_block_class`` and its kin raise ``NotImplementedError``).  Field
orders follow the consensus spec exactly: the state root depends on them.
Big state columns use the columnar numpy types of ``types.registry``.
"""

from functools import lru_cache
from types import SimpleNamespace

from lighthouse_tpu_torch import ssz
from lighthouse_tpu_torch.types.registry import (
    RootsList,
    RootsVector,
    U8List,
    U64List,
    U64Vector,
    ValidatorRegistryType,
)
from lighthouse_tpu_torch.types.spec import Preset

JUSTIFICATION_BITS_LENGTH = 4
DEPOSIT_CONTRACT_TREE_DEPTH = 32


class Fork(ssz.Container):
    previous_version: ssz.Bytes4
    current_version: ssz.Bytes4
    epoch: ssz.uint64


class Checkpoint(ssz.Container):
    epoch: ssz.uint64
    root: ssz.Bytes32


class Validator(ssz.Container):
    """Object view of one registry row (columnar store: registry.Validators)."""

    pubkey: ssz.Bytes48
    withdrawal_credentials: ssz.Bytes32
    effective_balance: ssz.uint64
    slashed: ssz.boolean
    activation_eligibility_epoch: ssz.uint64
    activation_epoch: ssz.uint64
    exit_epoch: ssz.uint64
    withdrawable_epoch: ssz.uint64


class BeaconBlockHeader(ssz.Container):
    slot: ssz.uint64
    proposer_index: ssz.uint64
    parent_root: ssz.Bytes32
    state_root: ssz.Bytes32
    body_root: ssz.Bytes32


class SignedBeaconBlockHeader(ssz.Container):
    message: BeaconBlockHeader
    signature: ssz.Bytes96


class Eth1Data(ssz.Container):
    deposit_root: ssz.Bytes32
    deposit_count: ssz.uint64
    block_hash: ssz.Bytes32


class DepositMessage(ssz.Container):
    pubkey: ssz.Bytes48
    withdrawal_credentials: ssz.Bytes32
    amount: ssz.uint64


class DepositData(ssz.Container):
    pubkey: ssz.Bytes48
    withdrawal_credentials: ssz.Bytes32
    amount: ssz.uint64
    signature: ssz.Bytes96


class Deposit(ssz.Container):
    proof: ssz.Vector(ssz.Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)
    data: DepositData


class VoluntaryExit(ssz.Container):
    epoch: ssz.uint64
    validator_index: ssz.uint64


class SignedVoluntaryExit(ssz.Container):
    message: VoluntaryExit
    signature: ssz.Bytes96


class ProposerSlashing(ssz.Container):
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class Withdrawal(ssz.Container):
    index: ssz.uint64
    validator_index: ssz.uint64
    address: ssz.Bytes20
    amount: ssz.uint64


class BLSToExecutionChange(ssz.Container):
    validator_index: ssz.uint64
    from_bls_pubkey: ssz.Bytes48
    to_execution_address: ssz.Bytes20


class SignedBLSToExecutionChange(ssz.Container):
    message: BLSToExecutionChange
    signature: ssz.Bytes96


class ForkData(ssz.Container):
    current_version: ssz.Bytes4
    genesis_validators_root: ssz.Bytes32


class AttestationData(ssz.Container):
    slot: ssz.uint64
    index: ssz.uint64
    beacon_block_root: ssz.Bytes32
    source: Checkpoint
    target: Checkpoint


class SigningData(ssz.Container):
    object_root: ssz.Bytes32
    domain: ssz.Bytes32


class HistoricalSummary(ssz.Container):
    block_summary_root: ssz.Bytes32
    state_summary_root: ssz.Bytes32


def _container(name: str, field_specs: list[tuple[str, object]]):
    """Build an ssz.Container subclass with exact field order."""
    return type(name, (ssz.Container,), {"__annotations__": dict(field_specs)})


@lru_cache(maxsize=2)
def make_types(preset: Preset) -> SimpleNamespace:
    """The preset-dependent containers: ``SyncCommittee``,
    ``ExecutionPayloadHeaderDeneb``, ``BeaconStateDeneb``, the Deneb
    ``Attestation`` (phase0 to Deneb share its layout), and the Deneb block:
    ``IndexedAttestation``, ``AttesterSlashing``, ``SyncAggregate``,
    ``Transactions``, ``ExecutionPayloadDeneb``, ``BeaconBlockBodyDeneb``,
    ``BeaconBlockDeneb``, ``SignedBeaconBlockDeneb``; with
    ``beacon_block_class(fork)`` and its kin, and ``decode_signed_block``."""
    P = preset

    SyncCommittee = _container("SyncCommittee", [
        ("pubkeys", ssz.Vector(ssz.Bytes48, P.sync_committee_size)),
        ("aggregate_pubkey", ssz.Bytes48),
    ])

    _payload_base = [
        ("parent_hash", ssz.Bytes32),
        ("fee_recipient", ssz.Bytes20),
        ("state_root", ssz.Bytes32),
        ("receipts_root", ssz.Bytes32),
        ("logs_bloom", ssz.ByteVector(P.bytes_per_logs_bloom)),
        ("prev_randao", ssz.Bytes32),
        ("block_number", ssz.uint64),
        ("gas_limit", ssz.uint64),
        ("gas_used", ssz.uint64),
        ("timestamp", ssz.uint64),
        ("extra_data", ssz.ByteList(P.max_extra_data_bytes)),
        ("base_fee_per_gas", ssz.uint256),
        ("block_hash", ssz.Bytes32),
    ]
    _blob_gas = [("blob_gas_used", ssz.uint64), ("excess_blob_gas", ssz.uint64)]

    ExecutionPayloadHeaderDeneb = _container(
        "ExecutionPayloadHeaderDeneb",
        _payload_base + [("transactions_root", ssz.Bytes32),
                         ("withdrawals_root", ssz.Bytes32)] + _blob_gas)

    Transactions = ssz.List(ssz.ByteList(P.max_bytes_per_transaction),
                            P.max_transactions_per_payload)
    ExecutionPayloadDeneb = _container(
        "ExecutionPayloadDeneb",
        _payload_base + [("transactions", Transactions),
                         ("withdrawals", ssz.List(Withdrawal, P.max_withdrawals_per_payload))]
        + _blob_gas)

    BeaconStateDeneb = _container("BeaconStateDeneb", [
        ("genesis_time", ssz.uint64),
        ("genesis_validators_root", ssz.Bytes32),
        ("slot", ssz.uint64),
        ("fork", Fork),
        ("latest_block_header", BeaconBlockHeader),
        ("block_roots", RootsVector(P.slots_per_historical_root)),
        ("state_roots", RootsVector(P.slots_per_historical_root)),
        ("historical_roots", RootsList(P.historical_roots_limit)),
        ("eth1_data", Eth1Data),
        ("eth1_data_votes", ssz.List(
            Eth1Data, P.epochs_per_eth1_voting_period * P.slots_per_epoch)),
        ("eth1_deposit_index", ssz.uint64),
        ("validators", ValidatorRegistryType(P.validator_registry_limit)),
        ("balances", U64List(P.validator_registry_limit)),
        ("randao_mixes", RootsVector(P.epochs_per_historical_vector)),
        ("slashings", U64Vector(P.epochs_per_slashings_vector)),
        ("previous_epoch_participation", U8List(P.validator_registry_limit)),
        ("current_epoch_participation", U8List(P.validator_registry_limit)),
        ("justification_bits", ssz.Bitvector(JUSTIFICATION_BITS_LENGTH)),
        ("previous_justified_checkpoint", Checkpoint),
        ("current_justified_checkpoint", Checkpoint),
        ("finalized_checkpoint", Checkpoint),
        ("inactivity_scores", U64List(P.validator_registry_limit)),
        ("current_sync_committee", SyncCommittee),
        ("next_sync_committee", SyncCommittee),
        ("latest_execution_payload_header", ExecutionPayloadHeaderDeneb),
        ("next_withdrawal_index", ssz.uint64),
        ("next_withdrawal_validator_index", ssz.uint64),
        ("historical_summaries", ssz.List(HistoricalSummary, P.historical_roots_limit)),
    ])

    Attestation = _container("Attestation", [
        ("aggregation_bits", ssz.Bitlist(P.max_validators_per_committee)),
        ("data", AttestationData),
        ("signature", ssz.Bytes96),
    ])

    IndexedAttestation = _container("IndexedAttestation", [
        ("attesting_indices", U64List(P.max_validators_per_committee)),
        ("data", AttestationData),
        ("signature", ssz.Bytes96),
    ])

    AttesterSlashing = _container("AttesterSlashing", [
        ("attestation_1", IndexedAttestation),
        ("attestation_2", IndexedAttestation),
    ])

    SyncAggregate = _container("SyncAggregate", [
        ("sync_committee_bits", ssz.Bitvector(P.sync_committee_size)),
        ("sync_committee_signature", ssz.Bytes96),
    ])

    BeaconBlockBodyDeneb = _container("BeaconBlockBodyDeneb", [
        ("randao_reveal", ssz.Bytes96),
        ("eth1_data", Eth1Data),
        ("graffiti", ssz.Bytes32),
        ("proposer_slashings", ssz.List(ProposerSlashing, P.max_proposer_slashings)),
        ("attester_slashings", ssz.List(AttesterSlashing, P.max_attester_slashings)),
        ("attestations", ssz.List(Attestation, P.max_attestations)),
        ("deposits", ssz.List(Deposit, P.max_deposits)),
        ("voluntary_exits", ssz.List(SignedVoluntaryExit, P.max_voluntary_exits)),
        ("sync_aggregate", SyncAggregate),
        ("execution_payload", ExecutionPayloadDeneb),
        ("bls_to_execution_changes",
         ssz.List(SignedBLSToExecutionChange, P.max_bls_to_execution_changes)),
        ("blob_kzg_commitments", ssz.List(ssz.Bytes48, P.max_blob_commitments_per_block)),
    ])

    BeaconBlockDeneb = _container("BeaconBlockDeneb", [
        ("slot", ssz.uint64),
        ("proposer_index", ssz.uint64),
        ("parent_root", ssz.Bytes32),
        ("state_root", ssz.Bytes32),
        ("body", BeaconBlockBodyDeneb),
    ])

    SignedBeaconBlockDeneb = _container("SignedBeaconBlockDeneb", [
        ("message", BeaconBlockDeneb),
        ("signature", ssz.Bytes96),
    ])

    # the commitment's branch: the body's 16 field roots (depth 4), the
    # list's length mix-in (1) and the commitments' chunk tree
    inclusion_depth = 4 + 1 + max(P.max_blob_commitments_per_block - 1, 1).bit_length()
    BlobSidecar = _container("BlobSidecar", [
        ("index", ssz.uint64),
        ("blob", ssz.ByteVector(P.field_elements_per_blob * 32)),
        ("kzg_commitment", ssz.Bytes48),
        ("kzg_proof", ssz.Bytes48),
        ("signed_block_header", SignedBeaconBlockHeader),
        ("kzg_commitment_inclusion_proof", ssz.Vector(ssz.Bytes32, inclusion_depth)),
    ])

    def _deneb(kind: str, cls):
        def by_fork(fork: str):
            if fork != "deneb":
                raise NotImplementedError(
                    f"{kind} of fork {fork!r}: only Deneb blocks are ported (ROADMAP A 16)")
            return cls
        return by_fork

    def decode_signed_block(raw: bytes):
        """Decode a Deneb SignedBeaconBlock; None if the bytes do not fit."""
        try:
            return SignedBeaconBlockDeneb.deserialize(raw)
        except (ValueError, IndexError):
            return None

    return SimpleNamespace(
        preset=P,
        Attestation=Attestation,
        AttesterSlashing=AttesterSlashing,
        BeaconBlockBodyDeneb=BeaconBlockBodyDeneb,
        BeaconBlockDeneb=BeaconBlockDeneb,
        BeaconStateDeneb=BeaconStateDeneb,
        BlobSidecar=BlobSidecar,
        ExecutionPayloadDeneb=ExecutionPayloadDeneb,
        ExecutionPayloadHeaderDeneb=ExecutionPayloadHeaderDeneb,
        IndexedAttestation=IndexedAttestation,
        SignedBeaconBlockDeneb=SignedBeaconBlockDeneb,
        SyncAggregate=SyncAggregate,
        SyncCommittee=SyncCommittee,
        Transactions=Transactions,
        beacon_block_class=_deneb("beacon block", BeaconBlockDeneb),
        signed_beacon_block_class=_deneb("signed beacon block", SignedBeaconBlockDeneb),
        beacon_block_body_class=_deneb("beacon block body", BeaconBlockBodyDeneb),
        decode_signed_block=decode_signed_block,
    )
