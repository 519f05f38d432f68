"""Seeded inputs for smoke runs and tests: Deneb beacon states and BLS
signature-set batches.

The registry columns follow the fill of the JAX package's state-root
benchmark (``bench.py``, 1M-validator ``tree_hash_root``): random pubkeys
and withdrawal credentials, 32 ETH effective balances and balances, no
exits, zeroed participation and inactivity.  The rest of the state is
random where a real state holds hashes (roots, mixes, sync committees).

``epoch_state`` fills the registry for an epoch transition: as the JAX
package's ``randomized_registry_state`` does (a stress fill that engages
every stage), or in a live mainnet chain's proportions.

The signature batches are the two of ``BASELINE.json``: the signature sets
of one mainnet block (``block_signature_sets``) and the 1k-set
``verify_signature_sets`` microbench (``microbench_sets``).
"""

from __future__ import annotations

import hashlib

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


def epoch_state(n_validators: int, seed: int, preset: str = "mainnet", fill: str = "stress"):
    """A Deneb state of ``n_validators`` at the last slot of an epoch E, its
    registry filled for an epoch transition.  Returns ``(state, spec)``.

    ``fill="stress"`` (the default) is the JAX package's
    ``randomized_registry_state`` fill (``lighthouse_tpu/testing.py:355``)
    with ``eject_frac=0.0``, as its epoch benchmark uses at 2^20: every
    stage engages, far beyond what a live chain does (half the effective
    balances are at or below the ejection balance).  ``fill="mainnet"``
    shapes the registry as a finalizing mainnet chain does
    (``_mainnet_fill``): what an operator's node crosses every epoch.

    E + 1 is no sync-committee period boundary, so the random pubkeys are
    never decompressed.  The minimal preset's spec activates every fork
    through Deneb at genesis."""
    fills = {"stress": _stress_fill, "mainnet": _mainnet_fill}
    if fill not in fills:
        raise ValueError(f"unknown fill {fill!r}: use one of {sorted(fills)}")
    state, spec = build_state(n_validators, seed, preset)
    if preset != "mainnet":
        spec = spec.with_forks_at(0, "deneb")
        state.fork = Fork(previous_version=spec.capella_fork_version,
                          current_version=spec.deneb_fork_version, epoch=0)
    P = spec.preset
    epoch = int(state.slot) // P.slots_per_epoch
    if (epoch + 1) % P.epochs_per_sync_committee_period == 0:
        raise ValueError(f"epoch {epoch} ends a sync-committee period")
    fills[fill](state, spec, epoch, np.random.default_rng(seed))
    state.slot = (epoch + 1) * P.slots_per_epoch - 1
    header = state.latest_block_header
    state.latest_block_header = BeaconBlockHeader(
        slot=int(state.slot) - 1, proposer_index=header.proposer_index,
        parent_root=header.parent_root, state_root=b"\x00" * 32, body_root=header.body_root)
    return state, spec


def _stress_fill(state, spec, epoch: int, rng: np.random.Generator) -> None:
    """The reference's fill: random effective balances in whole increments,
    20% not yet eligible, 10% not yet activated, 15% with a scheduled exit,
    8% slashed (half of them on the slashings target), balances around the
    effective ones, random participation flags and inactivity scores, and
    one nonzero slashings entry.  The reference's epochs count from a
    transition at epoch 1; here they are shifted to E, so that the
    activation queue (eligibility at the finalized epoch), the exits and the
    slashed lanes on the slashings target all engage."""
    P = spec.preset
    n = len(state.validators)
    far = np.uint64(FAR_FUTURE_EPOCH)
    shift = np.uint64(epoch - 1)
    incr = spec.effective_balance_increment
    v = state.validators
    v.effective_balance = rng.integers(
        0, spec.max_effective_balance // incr + 1, n).astype(np.uint64) * np.uint64(incr)
    finalized = np.uint64(int(state.finalized_checkpoint.epoch))    # epoch - 2
    v.activation_eligibility_epoch = np.where(rng.random(n) < 0.2, far, finalized)
    v.activation_epoch = np.where(rng.random(n) < 0.1, far,
                                  rng.integers(0, 3, n).astype(np.uint64) + shift)
    exit_far = rng.random(n) < 0.85
    v.exit_epoch = np.where(exit_far, far, rng.integers(3, 50, n).astype(np.uint64) + shift)
    v.withdrawable_epoch = np.where(
        v.exit_epoch == far, far,
        v.exit_epoch + np.uint64(spec.min_validator_withdrawability_delay))
    slashed = rng.random(n) < 0.08
    v.slashed = slashed
    v.exit_epoch[slashed] = np.uint64(5) + shift
    target = epoch + P.epochs_per_slashings_vector // 2
    idx = np.nonzero(slashed)[0]
    v.withdrawable_epoch[idx] = rng.choice([target, target + 3], idx.size).astype(np.uint64)
    rng.random(n)                   # the reference's ejection draw, at eject_frac 0
    state.balances = (v.effective_balance.astype(np.int64)
                      + rng.integers(-10**9, 2 * 10**9, n)).clip(0).astype(np.uint64)
    state.previous_epoch_participation = rng.integers(0, 8, n, dtype=np.uint8)
    state.current_epoch_participation = rng.integers(0, 8, n, dtype=np.uint8)
    state.inactivity_scores = rng.integers(0, 200, n).astype(np.uint64)
    state.slashings[0] = np.uint64(int(rng.integers(0, 64)) * incr)


def _mainnet_fill(state, spec, epoch: int, rng: np.random.Generator) -> None:
    """A finalizing chain's registry, in the proportions of mainnet's (set
    by hand, not read from a chain): 2% exited and withdrawn (balance 0);
    an activation queue of 0.5% at 32 ETH; one epoch's churn of new
    deposits; a quarter of one epoch's churn ejected at the ejection
    balance; twelve epochs of churn of voluntary exits already queued from
    E + 1 on, so the ejections join a full tail; max(2, n / 65536) slashed
    validators, half on the slashings target; the rest active since early
    epochs, 99.5% of them at 32 ETH with up to 0.03 ETH of rewards since
    the last withdrawal sweep and the others at 17-31 ETH, balances either
    side of their hysteresis; 96% timely on all three flags, 2% on source
    and target, 1% on source, 1% offline, in both epochs; inactivity
    scores 0 but for 1% left over from an old leak."""
    P = spec.preset
    n = len(state.validators)
    v = state.validators
    far = np.uint64(FAR_FUTURE_EPOCH)
    max_eff, incr = spec.max_effective_balance, spec.effective_balance_increment
    delay = spec.min_validator_withdrawability_delay
    churn = max(spec.min_per_epoch_churn_limit, n // spec.churn_limit_quotient)
    counts = [n // 50, n // 200, churn, max(1, churn // 4), 12 * churn, max(2, n // 65536)]
    if sum(counts) > n:
        raise ValueError(f"{n} validators cannot hold the mainnet fill's groups {counts}")
    rows = rng.permutation(n)[:sum(counts)]
    withdrawn, pending, deposit, eject, exiting, slashed = np.split(rows, np.cumsum(counts)[:-1])

    v.activation_eligibility_epoch = np.zeros(n, np.uint64)
    v.activation_epoch = rng.integers(0, epoch // 2 + 1, n).astype(np.uint64)
    v.effective_balance = np.full(n, max_eff, np.uint64)
    tail = rng.random(n) < 0.005
    v.effective_balance[tail] = rng.integers(17, 32, int(tail.sum())).astype(np.uint64) * incr
    balances = v.effective_balance.astype(np.int64) + rng.integers(0, 3 * 10**7, n)
    balances[tail] += rng.integers(-incr // 2, 3 * incr // 2, int(tail.sum()))
    v.exit_epoch = np.full(n, far, np.uint64)
    v.withdrawable_epoch = np.full(n, far, np.uint64)

    v.activation_epoch[withdrawn] = 0
    v.exit_epoch[withdrawn] = rng.integers(1, max(epoch - delay, 2), withdrawn.size)
    v.withdrawable_epoch[withdrawn] = v.exit_epoch[withdrawn] + np.uint64(delay)
    v.effective_balance[withdrawn] = 0
    balances[withdrawn] = 0
    finalized = int(state.finalized_checkpoint.epoch)
    v.activation_eligibility_epoch[pending] = rng.integers(
        max(finalized - 50, 0), finalized + 1, pending.size)
    for group in (pending, deposit):
        v.activation_epoch[group] = far
        v.effective_balance[group] = max_eff
        balances[group] = max_eff
    v.activation_eligibility_epoch[deposit] = far
    v.effective_balance[eject] = spec.ejection_balance
    balances[eject] = spec.ejection_balance + rng.integers(0, incr // 2, eject.size)
    v.exit_epoch[exiting] = np.uint64(epoch + 1) + np.arange(exiting.size, dtype=np.uint64) // np.uint64(churn)
    v.withdrawable_epoch[exiting] = v.exit_epoch[exiting] + np.uint64(delay)
    v.slashed = np.zeros(n, bool)
    v.slashed[slashed] = True
    v.activation_epoch[slashed] = 0
    v.exit_epoch[slashed] = np.uint64(max(epoch - 1, 0))
    target = epoch + P.epochs_per_slashings_vector // 2
    v.withdrawable_epoch[slashed] = rng.choice([target, target + 3], slashed.size)
    v.effective_balance[slashed] = max_eff
    balances[slashed] = max_eff - max_eff // 32
    state.balances = balances.astype(np.uint64)

    flags = np.array([0b111, 0b011, 0b001, 0], np.uint8)
    odds = [0.96, 0.02, 0.01, 0.01]
    for name, at in (("previous_epoch_participation", epoch - 1),
                     ("current_epoch_participation", epoch)):
        part = flags[rng.choice(4, n, p=odds)]
        part[~v.is_active(max(at, 0))] = 0
        setattr(state, name, part)
    scores = np.zeros(n, np.uint64)
    old = rng.random(n) < 0.01
    scores[old] = rng.integers(1, 64, int(old.sum()))
    state.inactivity_scores = scores
    state.slashings[epoch % P.epochs_per_slashings_vector] = np.uint64(slashed.size * max_eff)


def registry_state_digest(state) -> str:
    """Hex digest of every column an epoch transition mutates (the JAX
    package's ``registry_state_digest``, ``lighthouse_tpu/testing.py:431``)."""
    h = hashlib.sha256()
    v = state.validators
    for arr in (state.balances, v.effective_balance, state.inactivity_scores,
                v.activation_eligibility_epoch, v.activation_epoch, v.exit_epoch,
                v.withdrawable_epoch, v.slashed, state.previous_epoch_participation,
                state.current_epoch_participation, state.slashings):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(int(state.finalized_checkpoint.epoch).to_bytes(8, "little"))
    h.update(int(state.current_justified_checkpoint.epoch).to_bytes(8, "little"))
    return h.hexdigest()


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
