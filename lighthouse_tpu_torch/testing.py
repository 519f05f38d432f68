"""Seeded inputs for smoke runs and tests: Deneb beacon states and BLS
signature-set batches.

The registry columns follow the fill of the JAX package's state-root
benchmark (``bench.py``, 1M-validator ``tree_hash_root``): random pubkeys
and withdrawal credentials, 32 ETH effective balances and balances, no
exits, zeroed participation and inactivity.  The rest of the state is
random where a real state holds hashes (roots, mixes, sync committees).

The signature batches are the two of ``BASELINE.json``: the signature sets
of one mainnet block (``block_signature_sets``) and the 1k-set
``verify_signature_sets`` microbench (``microbench_sets``).
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import P as FIELD_P, R as GROUP_R, Fq2

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


# --------------------------------------------------------------------------
# BLS signature-set batches
# --------------------------------------------------------------------------

COMMITTEES_PER_SLOT = 64        # mainnet MAX_COMMITTEES_PER_SLOT
MAX_ATTESTATIONS = 128          # Deneb block body limit
SYNC_COMMITTEE_SIZE = 512


def consecutive_pubkeys(s0: int, n: int) -> list:
    """Public keys of the secret scalars s0, s0 + 1, ..., s0 + n - 1:
    pk_{i+1} = pk_i + G, one host point addition per key."""
    g = cv.g1_generator()
    pt = cv.g1_mul(g, s0)
    out = []
    for _ in range(n):
        out.append(bls.PublicKey(cv.g1_to_bytes(pt), pt))
        pt = cv.g1_add(pt, g)
    return out


def _aggregate_sign(sk_sum: int, message: bytes) -> bls.Signature:
    """The aggregate of the members' signatures over ``message``: sign with
    the sum of their secret keys mod r (Σ sk_i·H(m) = (Σ sk_i)·H(m))."""
    return bls.SecretKey(sk_sum % GROUP_R).sign(message)


def block_signature_sets(seed: int, n_validators: int = 1 << 20) -> list:
    """The signature sets of one mainnet Deneb block at ``n_validators``
    validators, made with numpy from ``seed``: MAX_ATTESTATIONS aggregate
    attestations, each over a whole committee of n / (32 · 64) members
    (committees of two slots, so all members differ), the sync aggregate
    over SYNC_COMMITTEE_SIZE keys sampled with replacement (duplicates),
    then the proposer's block signature and randao reveal.  At 2^20
    validators: 131 sets over 66,050 member keys.

    Member secret keys are consecutive scalars s0 + i, so the keys cost one
    point addition each; an aggregate signature is ``sign`` with the sum of
    the members' keys mod r, which equals the aggregate of their
    signatures."""
    rng = np.random.default_rng(seed)
    committee = n_validators // (32 * COMMITTEES_PER_SLOT)
    n_keys = MAX_ATTESTATIONS * committee
    s0 = int(rng.integers(1, 1 << 62))
    pks = consecutive_pubkeys(s0, n_keys)
    order = rng.permutation(n_keys)
    msgs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(MAX_ATTESTATIONS + 3)]
    sets = []
    for a in range(MAX_ATTESTATIONS):
        members = order[a * committee:(a + 1) * committee]
        sk_sum = int(members.sum()) + s0 * committee
        sets.append(bls.SignatureSet(_aggregate_sign(sk_sum, msgs[a]),
                                     [pks[int(i)] for i in members], msgs[a]))
    sync = rng.integers(0, n_keys, SYNC_COMMITTEE_SIZE)
    sets.append(bls.SignatureSet(
        _aggregate_sign(int(sync.sum()) + s0 * SYNC_COMMITTEE_SIZE, msgs[-3]),
        [pks[int(i)] for i in sync], msgs[-3]))
    proposer = int(rng.integers(0, n_keys))
    for msg in msgs[-2:]:
        sets.append(bls.SignatureSet(_aggregate_sign(s0 + proposer, msg), [pks[proposer]], msg))
    return sets


def microbench_sets(n_sets: int = 1024) -> list:
    """The 1k-set microbench as the JAX package's ``bench.py`` builds it:
    single-key sets over min(64, n) messages and min(256, n) keys from
    ``default_rng(3)``; set i uses key i % 256 and message i % 64."""
    rng = np.random.default_rng(3)
    n_msgs = min(64, n_sets)
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n_msgs)]
    sks = [bls.SecretKey.from_bytes(int(7 + i).to_bytes(32, "big"))
           for i in range(min(256, n_sets))]
    pks = [sk.public_key() for sk in sks]
    sigs: dict = {}
    sets = []
    for i in range(n_sets):
        k, m = i % len(sks), i % n_msgs
        if (k, m) not in sigs:
            sigs[(k, m)] = sks[k].sign(msgs[m])
        sets.append(bls.SignatureSet(sigs[(k, m)], [pks[k]], msgs[m]))
    return sets


def fresh(sets: list) -> list:
    """The same sets with new Signature objects from their bytes, so that
    decompression and the subgroup check run again; keys stay cached."""
    return [bls.SignatureSet(bls.Signature(s.signature.to_bytes()), s.pubkeys, s.message)
            for s in sets]


def with_wrong_message(sets: list, i: int) -> list:
    """Set i signs another message than it claims: the batch must fail."""
    out = list(sets)
    out[i] = bls.SignatureSet(sets[i].signature, sets[i].pubkeys, bytes(32))
    return out


# a twist point of exact order 13: it meets the H == 0 chord inside the ψ
# check's scalar mul, which must then reject it (the point pinned by the JAX
# package's tests/test_ec.py::test_small_order_point_fails_closed)
SMALL_ORDER_G2 = (
    Fq2(0x50c3dd2263b07fd4c50559754c4f0d4c4ab0cdc4a685b8b5cab7bd39bd46ceda6663d15c194176fc6e15f40a70b76bc,
        0x2fce515472b308fa3da1ac9a6fa4019d7a8700cb6ca215771c98d4bc59edddbedf882c6cae0f702b73c6bdcb93746ac),
    Fq2(0xdc3af5921e8ecd27695da0f537a9197d849deabb8cf404f28ba31790ce2e89a26bb85188dab735e6782210cd0a30381,
        0x2eaa3a19068450560e6cc5788d89c55226e62b286277cecfaa019ad4712e2db26a4495408885d5923bed176515a1bb1),
)


def non_subgroup_point(seed: int):
    """A point of the twist E'(Fq2) outside the order-r subgroup G2."""
    rng = np.random.default_rng(seed)
    while True:
        x = Fq2(int.from_bytes(rng.bytes(47), "big") % FIELD_P,
                int.from_bytes(rng.bytes(47), "big") % FIELD_P)
        y = (x.square() * x + cv.B2).sqrt()
        if y is not None and not cv.g2_in_subgroup((x, y)):
            return x, y


def with_non_subgroup_signature(sets: list, i: int, seed: int = 9) -> list:
    """Set i carries a decompressable signature outside G2."""
    out = list(sets)
    pt = non_subgroup_point(seed)
    out[i] = bls.SignatureSet(bls.Signature(cv.g2_to_bytes(pt)), sets[i].pubkeys,
                              sets[i].message)
    return out


def with_identity_aggregate(sets: list, i: int) -> list:
    """Set i's members are a key and its negation repeated: their
    aggregate is the identity, which can never verify."""
    out = list(sets)
    pk = sets[i].pubkeys[0]
    neg = cv.g1_neg(pk.point)
    members = [pk, bls.PublicKey(cv.g1_to_bytes(neg), neg)] * 9
    out[i] = bls.SignatureSet(sets[i].signature, members, sets[i].message)
    return out
