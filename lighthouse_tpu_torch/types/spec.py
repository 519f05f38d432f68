"""Presets and the slice of the chain spec that Deneb states, slot and
epoch processing and the committee shuffle need.

Port of ``lighthouse_tpu/types/spec.py``: a ``Preset`` holds the sizes
that shape the state's SSZ types and the committee math, a ``ChainSpec``
the runtime constants and the fork schedule.  Every field keeps the name
and value it has in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0

# Fork names in activation order.
FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb", "electra")


@dataclass(frozen=True)
class Preset:
    """Compile-time sizes of the Deneb beacon state, its committees and
    its block bodies."""

    name: str
    slots_per_epoch: int
    max_committees_per_slot: int
    target_committee_size: int
    shuffle_round_count: int
    slots_per_historical_root: int
    epochs_per_historical_vector: int
    epochs_per_slashings_vector: int
    historical_roots_limit: int
    validator_registry_limit: int
    epochs_per_eth1_voting_period: int
    sync_committee_size: int
    epochs_per_sync_committee_period: int
    bytes_per_logs_bloom: int
    max_extra_data_bytes: int
    max_validators_per_committee: int = 2048     # both presets
    # block body and execution payload limits (both presets but the sweep)
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_deposits: int = 16
    max_voluntary_exits: int = 16
    max_bls_to_execution_changes: int = 16
    max_bytes_per_transaction: int = 2**30
    max_transactions_per_payload: int = 2**20
    max_blob_commitments_per_block: int = 4096
    # blobs (both presets)
    field_elements_per_blob: int = 4096
    max_blobs_per_block: int = 6
    max_withdrawals_per_payload: int = 16
    max_validators_per_withdrawals_sweep: int = 16384


MAINNET_PRESET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    max_committees_per_slot=64,
    target_committee_size=128,
    shuffle_round_count=90,
    slots_per_historical_root=8192,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    epochs_per_eth1_voting_period=64,
    sync_committee_size=512,
    epochs_per_sync_committee_period=256,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
)

MINIMAL_PRESET = Preset(
    name="minimal",
    slots_per_epoch=8,
    max_committees_per_slot=4,
    target_committee_size=4,
    shuffle_round_count=10,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    epochs_per_eth1_voting_period=4,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
    max_withdrawals_per_payload=4,
    max_validators_per_withdrawals_sweep=16,
)

PRESETS = {p.name: p for p in (MAINNET_PRESET, MINIMAL_PRESET)}


@dataclass(frozen=True)
class ChainSpec:
    """Runtime constants and fork schedule (reference chain_spec.rs), the
    slice that Deneb slot and epoch processing read."""

    preset: Preset = MAINNET_PRESET
    config_name: str = "mainnet"

    # balances (Gwei)
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5

    # time parameters
    seconds_per_slot: int = 12
    min_attestation_inclusion_delay: int = 1
    shard_committee_period: int = 256
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_validator_withdrawability_delay: int = 256
    min_epochs_to_inactivity_penalty: int = 4

    # rewards and penalties (Bellatrix values hold from Bellatrix on)
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    min_slashing_penalty_quotient_bellatrix: int = 32
    inactivity_penalty_quotient_bellatrix: int = 2**24
    proportional_slashing_multiplier_bellatrix: int = 3
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16

    # validator cycle
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 2**16
    max_per_epoch_activation_churn_limit: int = 8

    # fork schedule: version (4 bytes) and activation epoch per fork
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    electra_fork_version: bytes = b"\x05\x00\x00\x00"
    altair_fork_epoch: int = 74240
    bellatrix_fork_epoch: int = 144896
    capella_fork_epoch: int = 194048
    deneb_fork_epoch: int = 269568
    electra_fork_epoch: int = FAR_FUTURE_EPOCH

    # domains (4-byte little-endian tags)
    # fork choice
    proposer_score_boost: int = 40
    domain_beacon_proposer: int = 0
    domain_beacon_attester: int = 1
    domain_randao: int = 2
    domain_deposit: int = 3
    domain_voluntary_exit: int = 4
    domain_selection_proof: int = 5
    domain_aggregate_and_proof: int = 6
    domain_sync_committee: int = 7
    domain_sync_committee_selection_proof: int = 8
    domain_contribution_and_proof: int = 9
    domain_bls_to_execution_change: int = 10

    @property
    def slots_per_epoch(self) -> int:
        return self.preset.slots_per_epoch

    def fork_epoch(self, fork: str) -> int:
        if fork == "phase0":
            return GENESIS_EPOCH
        return getattr(self, f"{fork}_fork_epoch")

    def fork_at_epoch(self, epoch: int) -> str:
        current = "phase0"
        for f in FORKS[1:]:
            if self.fork_epoch(f) <= epoch:
                current = f
        return current

    def compute_epoch_at_slot(self, slot: int) -> int:
        return slot // self.slots_per_epoch

    def compute_start_slot_at_epoch(self, epoch: int) -> int:
        return epoch * self.slots_per_epoch

    def compute_activation_exit_epoch(self, epoch: int) -> int:
        return epoch + 1 + self.max_seed_lookahead

    def with_forks_at(self, epoch: int, through: str = "capella") -> "ChainSpec":
        """Activate every fork up to ``through`` at ``epoch`` and the later
        ones never (the JAX package's testing helper)."""
        last = FORKS.index(through)
        return replace(self, **{
            f"{f}_fork_epoch": epoch if i <= last else FAR_FUTURE_EPOCH
            for i, f in enumerate(FORKS[1:], start=1)})

    @staticmethod
    def mainnet() -> "ChainSpec":
        return ChainSpec()

    @staticmethod
    def minimal() -> "ChainSpec":
        """The minimal config: every fork far in the future, as in the JAX
        package; ``with_forks_at(0, "deneb")`` gives a Deneb-at-genesis
        chain."""
        return ChainSpec(preset=MINIMAL_PRESET, config_name="minimal", seconds_per_slot=6,
                         shard_committee_period=64,
                         altair_fork_epoch=FAR_FUTURE_EPOCH,
                         bellatrix_fork_epoch=FAR_FUTURE_EPOCH,
                         capella_fork_epoch=FAR_FUTURE_EPOCH,
                         deneb_fork_epoch=FAR_FUTURE_EPOCH)
