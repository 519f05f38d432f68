"""Consensus types: presets, the columnar registry, Deneb containers."""

from lighthouse_tpu_torch.types.spec import (
    FAR_FUTURE_EPOCH,
    FORKS,
    GENESIS_EPOCH,
    MAINNET_PRESET,
    MINIMAL_PRESET,
    PRESETS,
    ChainSpec,
    Preset,
)
from lighthouse_tpu_torch.types.registry import (
    RootsList,
    RootsVector,
    U8List,
    U64List,
    U64Vector,
    ValidatorRegistryType,
    Validators,
)
from lighthouse_tpu_torch.types.containers import (
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    Eth1Data,
    Fork,
    ForkData,
    HistoricalSummary,
    SigningData,
    Validator,
    make_types,
)

__all__ = [
    "FAR_FUTURE_EPOCH", "FORKS", "GENESIS_EPOCH", "MAINNET_PRESET", "MINIMAL_PRESET", "PRESETS",
    "AttestationData", "ChainSpec", "ForkData", "Preset", "SigningData", "RootsList", "RootsVector", "U8List", "U64List",
    "U64Vector", "ValidatorRegistryType", "Validators", "BeaconBlockHeader",
    "Checkpoint", "Eth1Data", "Fork", "HistoricalSummary", "Validator",
    "make_types",
]
