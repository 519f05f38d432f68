"""The containers of a Deneb beacon state and of its gossip attestations,
parameterized by preset.

Port of the Deneb slice of ``lighthouse_tpu/types/containers.py``.  Field
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


class Eth1Data(ssz.Container):
    deposit_root: ssz.Bytes32
    deposit_count: ssz.uint64
    block_hash: ssz.Bytes32


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
    ``ExecutionPayloadHeaderDeneb``, ``BeaconStateDeneb`` and the Deneb
    ``Attestation`` (phase0 to Deneb share its layout)."""
    P = preset

    SyncCommittee = _container("SyncCommittee", [
        ("pubkeys", ssz.Vector(ssz.Bytes48, P.sync_committee_size)),
        ("aggregate_pubkey", ssz.Bytes48),
    ])

    ExecutionPayloadHeaderDeneb = _container("ExecutionPayloadHeaderDeneb", [
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
        ("transactions_root", ssz.Bytes32),
        ("withdrawals_root", ssz.Bytes32),
        ("blob_gas_used", ssz.uint64),
        ("excess_blob_gas", ssz.uint64),
    ])

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

    return SimpleNamespace(
        preset=P,
        Attestation=Attestation,
        SyncCommittee=SyncCommittee,
        ExecutionPayloadHeaderDeneb=ExecutionPayloadHeaderDeneb,
        BeaconStateDeneb=BeaconStateDeneb,
    )
