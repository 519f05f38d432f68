"""Presets and the slice of the chain spec that Deneb states and
``process_slot`` need.

Port of ``lighthouse_tpu/types/spec.py``: a ``Preset`` holds the sizes
that shape the state's SSZ types, a ``ChainSpec`` the runtime constants.
"""

from __future__ import annotations

from dataclasses import dataclass

FAR_FUTURE_EPOCH = 2**64 - 1


@dataclass(frozen=True)
class Preset:
    """Compile-time sizes of the Deneb beacon state."""

    name: str
    slots_per_epoch: int
    slots_per_historical_root: int
    epochs_per_historical_vector: int
    epochs_per_slashings_vector: int
    historical_roots_limit: int
    validator_registry_limit: int
    epochs_per_eth1_voting_period: int
    sync_committee_size: int
    bytes_per_logs_bloom: int
    max_extra_data_bytes: int


MAINNET_PRESET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    slots_per_historical_root=8192,
    epochs_per_historical_vector=65536,
    epochs_per_slashings_vector=8192,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    epochs_per_eth1_voting_period=64,
    sync_committee_size=512,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
)

MINIMAL_PRESET = Preset(
    name="minimal",
    slots_per_epoch=8,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    historical_roots_limit=2**24,
    validator_registry_limit=2**40,
    epochs_per_eth1_voting_period=4,
    sync_committee_size=32,
    bytes_per_logs_bloom=256,
    max_extra_data_bytes=32,
)

PRESETS = {p.name: p for p in (MAINNET_PRESET, MINIMAL_PRESET)}


@dataclass(frozen=True)
class ChainSpec:
    """Runtime constants (reference chain_spec.rs), Deneb slice."""

    preset: Preset = MAINNET_PRESET
    config_name: str = "mainnet"
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: int = 269568

    @property
    def slots_per_epoch(self) -> int:
        return self.preset.slots_per_epoch

    @staticmethod
    def mainnet() -> "ChainSpec":
        return ChainSpec()

    @staticmethod
    def minimal() -> "ChainSpec":
        return ChainSpec(preset=MINIMAL_PRESET, config_name="minimal",
                         deneb_fork_epoch=FAR_FUTURE_EPOCH)
