"""Seeded Deneb beacon states for smoke runs and tests.

The registry columns follow the fill of the JAX package's state-root
benchmark (``bench.py``, 1M-validator ``tree_hash_root``): random pubkeys
and withdrawal credentials, 32 ETH effective balances and balances, no
exits, zeroed participation and inactivity.  The rest of the state is
random where a real state holds hashes (roots, mixes, sync committees).
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.types import (
    FAR_FUTURE_EPOCH,
    BeaconBlockHeader,
    ChainSpec,
    Checkpoint,
    Eth1Data,
    Fork,
    Validators,
    make_types,
)


def build_state(n_validators: int, seed: int, preset: str = "mainnet"):
    """A Deneb state of ``n_validators`` made with numpy from ``seed``,
    at the first slot of an epoch past the Deneb fork.  Returns
    ``(state, spec)``."""
    spec = ChainSpec.mainnet() if preset == "mainnet" else ChainSpec.minimal()
    P = spec.preset
    t = make_types(P)
    rng = np.random.default_rng(seed)
    n = n_validators

    def roots(k: int) -> np.ndarray:
        return rng.integers(0, 256, (k, 32), dtype=np.uint8)

    def bytes_(k: int) -> bytes:
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()

    v = Validators(n)
    v.pubkeys = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    v.withdrawal_credentials = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    v.effective_balance = np.full(n, spec.max_effective_balance, dtype=np.uint64)
    v.exit_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
    v.withdrawable_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)

    epoch = 300_000 if preset == "mainnet" else 2
    slot = epoch * P.slots_per_epoch

    def committee():
        return t.SyncCommittee(
            pubkeys=[bytes_(48) for _ in range(P.sync_committee_size)],
            aggregate_pubkey=bytes_(48))

    state = t.BeaconStateDeneb(
        genesis_time=1_606_824_023,
        genesis_validators_root=bytes_(32),
        slot=slot,
        fork=Fork(previous_version=spec.capella_fork_version,
                  current_version=spec.deneb_fork_version,
                  epoch=min(spec.deneb_fork_epoch, epoch)),
        latest_block_header=BeaconBlockHeader(
            slot=slot - 1, proposer_index=int(rng.integers(0, n)),
            parent_root=bytes_(32), state_root=b"\x00" * 32, body_root=bytes_(32)),
        block_roots=roots(P.slots_per_historical_root),
        state_roots=roots(P.slots_per_historical_root),
        eth1_data=Eth1Data(deposit_root=bytes_(32), deposit_count=n,
                           block_hash=bytes_(32)),
        eth1_deposit_index=n,
        validators=v,
        balances=np.full(n, spec.max_effective_balance, dtype=np.uint64),
        randao_mixes=roots(P.epochs_per_historical_vector),
        previous_epoch_participation=np.zeros(n, dtype=np.uint8),
        current_epoch_participation=np.zeros(n, dtype=np.uint8),
        justification_bits=[True, True, True, False],
        previous_justified_checkpoint=Checkpoint(epoch=epoch - 2, root=bytes_(32)),
        current_justified_checkpoint=Checkpoint(epoch=epoch - 1, root=bytes_(32)),
        finalized_checkpoint=Checkpoint(epoch=epoch - 2, root=bytes_(32)),
        inactivity_scores=np.zeros(n, dtype=np.uint64),
        current_sync_committee=committee(),
        next_sync_committee=committee(),
        latest_execution_payload_header=t.ExecutionPayloadHeaderDeneb(
            parent_hash=bytes_(32), fee_recipient=bytes_(20),
            state_root=bytes_(32), receipts_root=bytes_(32),
            logs_bloom=bytes_(P.bytes_per_logs_bloom), prev_randao=bytes_(32),
            block_number=19_000_000, gas_limit=30_000_000, gas_used=15_000_000,
            timestamp=1_710_000_000, extra_data=b"lighthouse",
            base_fee_per_gas=10**10, block_hash=bytes_(32),
            transactions_root=bytes_(32), withdrawals_root=bytes_(32),
            blob_gas_used=393_216, excess_blob_gas=0),
        next_withdrawal_index=int(rng.integers(0, 2**32)),
        next_withdrawal_validator_index=int(rng.integers(0, n)),
    )
    return state, spec


def slot_diff(state, spec, rng: np.random.Generator) -> None:
    """Apply one block's worth of registry-column writes in place: the
    current-epoch participation flags of one slot's attesters (N/32
    random validators) and the balances of the sync committee (512 on
    mainnet) and the proposer."""
    n = len(state.validators)
    attesters = rng.choice(n, size=max(n // spec.slots_per_epoch, 1), replace=False)
    state.current_epoch_participation[attesters] |= np.uint8(0b111)
    paid = rng.choice(n, size=min(spec.preset.sync_committee_size + 1, n), replace=False)
    state.balances[paid] += rng.integers(1, 30_000, paid.size).astype(np.uint64)
