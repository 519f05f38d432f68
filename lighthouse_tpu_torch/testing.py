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
``verify_signature_sets`` microbench (``microbench_sets``).  ``kzg_cell``
builds its blob batch (config 5) with tampered and edge-case variants,
``flood_cell`` the gossip attestation flood (config 3) and
``flood_tampered`` its batch of bad rows, ``ceremony_dict`` a dev setup in
the trusted-setup file's format, ``non_g1_point`` a curve point outside G1.
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


KEY_CHAINS = 1024                # chains of consecutive keys built side by side


def consecutive_pubkeys(s0: int, n: int) -> list:
    """Public keys of the secret scalars s0, s0 + 1, ..., s0 + n - 1, with
    their points (pk_{i+1} = pk_i + G).  ``KEY_CHAINS`` chains of
    consecutive keys advance together, each step sharing one field
    inversion among the chains (Montgomery's trick), so a key costs a few
    host products."""
    g = cv.g1_generator()
    gx, gy = g
    lanes = max(1, min(KEY_CHAINS, n))
    step = -(-n // lanes)
    pts = [cv.g1_mul(g, s0 + j * step) for j in range(lanes)]
    out: list = [None] * n
    for k in range(step):
        for j, pt in enumerate(pts):
            i = j * step + k
            if i < n:
                out[i] = bls.PublicKey(cv.g1_to_bytes(pt), pt)
        if k + 1 == step:
            break
        dx = [(gx - x) % FIELD_P for x, _y in pts]
        if not all(dx):                    # a chain at ±G: add it alone
            pts = [cv.g1_add(pt, g) for pt in pts]
            continue
        prefix = [1] * (lanes + 1)
        for j, d in enumerate(dx):
            prefix[j + 1] = prefix[j] * d % FIELD_P
        inv = pow(prefix[lanes], FIELD_P - 2, FIELD_P)
        nxt = [None] * lanes
        for j in range(lanes - 1, -1, -1):
            inv_d = inv * prefix[j] % FIELD_P
            inv = inv * dx[j] % FIELD_P
            x, y = pts[j]
            lam = (gy - y) * inv_d % FIELD_P
            x3 = (lam * lam - x - gx) % FIELD_P
            nxt[j] = (x3, (lam * (x - x3) - y) % FIELD_P)
        pts = nxt
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


def kzg_blob(width: int, rng: np.random.Generator) -> bytes:
    """A blob of ``width`` field elements below 2^62, as the JAX package's
    ``bench.py`` draws them."""
    vals = rng.integers(0, 2**62, size=width)
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def kzg_cell(width: int = 4096, n_unique: int = 6, n_blocks: int = 128, seed: int = 11,
             settings=None, device=None) -> dict:
    """The KZG blob batch of the JAX package's benchmark (``bench.py``,
    BASELINE config 5): ``n_unique`` blobs from ``default_rng(seed)``,
    repeated over ``n_blocks`` blocks, on ``KzgSettings.dev(width)``, their
    commitments and proofs made by the port's own entry points on
    ``device``.  Returns a dict: ``settings``, ``blobs``, ``commitments``,
    ``proofs`` (the batch), ``unique`` (the first ``n_unique`` of each), and
    ``variants``, a list of dicts (``name``, ``blobs``, ``commitments``,
    ``proofs``, ``challenges`` (None, or challenges to force in place of
    the Fiat-Shamir ones) and ``valid``, the verdict a verifier must give):
    a swapped proof, a blob with one element changed, another blob's
    commitment, a non-canonical element (all invalid), a constant blob with
    its proof at infinity, and a proof at a challenge forced onto a domain
    point (both valid)."""
    from lighthouse_tpu_torch.crypto import kzg

    if n_unique < 2:
        raise ValueError("kzg_cell needs at least 2 unique blobs")
    if settings is None:
        settings = kzg.KzgSettings.dev(width, device=device)
    rng = np.random.default_rng(seed)
    uniq = [kzg_blob(width, rng) for _ in range(n_unique)]
    cs = [kzg.blob_to_kzg_commitment(b, settings, device) for b in uniq]
    proofs = [kzg.compute_blob_kzg_proof(b, c, settings, device) for b, c in zip(uniq, cs)]
    blobs, commits, prfs = uniq * n_blocks, cs * n_blocks, proofs * n_blocks

    def variant(name, valid, blobs=blobs, commitments=commits, proofs=prfs, challenges=None):
        return dict(name=name, blobs=list(blobs), commitments=list(commitments),
                    proofs=list(proofs), challenges=challenges, valid=valid)

    swapped = list(prfs)
    swapped[0], swapped[1] = prfs[1], prfs[0]
    k = int(rng.integers(0, width))
    changed = bytearray(blobs[0])
    changed[32 * k:32 * k + 32] = ((int.from_bytes(changed[32 * k:32 * k + 32], "big") + 1)
                                   % GROUP_R).to_bytes(32, "big")
    other_commit = list(commits)
    other_commit[0] = commits[1]
    non_canonical = list(blobs)
    non_canonical[1] = GROUP_R.to_bytes(32, "big") + blobs[1][32:]
    const_blob = (42).to_bytes(32, "big") * width
    const_c = kzg.blob_to_kzg_commitment(const_blob, settings, device)
    const_p = kzg.compute_blob_kzg_proof(const_blob, const_c, settings, device)
    zs = [kzg.compute_challenge(b, c, settings) for b, c in zip(blobs, commits)]
    zs[0] = settings.roots_brp[int(rng.integers(0, width))]
    root_proof, _ = kzg.compute_kzg_proof_impl(kzg.blob_to_polynomial(blobs[0], settings), zs[0],
                                               settings, device)
    variants = [
        variant("swapped proof", False, proofs=swapped),
        variant("changed blob element", False, blobs=[bytes(changed)] + blobs[1:]),
        variant("another blob's commitment", False, commitments=other_commit),
        variant("non-canonical element", False, blobs=non_canonical),
        variant("constant blob, proof at infinity", True, blobs=[const_blob] + blobs[1:],
                commitments=[const_c] + commits[1:], proofs=[const_p] + prfs[1:]),
        variant("challenge on a domain point", True, proofs=[root_proof] + prfs[1:],
                challenges=zs),
    ]
    return dict(settings=settings, blobs=blobs, commitments=commits, proofs=prfs,
                unique=(uniq, cs, proofs), variants=variants)


# --------------------------------------------------------------------------
# the gossip attestation flood (BASELINE config 3) and the trusted setup
# --------------------------------------------------------------------------

FLOOD_BATCH = 2048              # the admission batch of the JAX package's bench.py:342


def _attestation_blob(data_ssz: bytes, sig: bytes, committee_len: int, pos: int) -> bytes:
    """Wire bytes of a single-bit Deneb attestation: the bits offset, the
    data, the signature, then the bitlist with its delimiter."""
    bits = bytearray(committee_len // 8 + 1)
    bits[pos // 8] |= 1 << (pos % 8)
    bits[committee_len // 8] |= 1 << (committee_len % 8)
    return (4 + 128 + 96).to_bytes(4, "little") + data_ssz + sig + bytes(bits)


def flood_cell(n_validators: int = 1 << 16, n_atts: int = 1 << 15, seed: int = 7,
               batch: int = FLOOD_BATCH, n_spare: int = 0, device=None) -> dict:
    """The gossip attestation flood of BASELINE config 3: a mainnet-preset
    Deneb state of ``n_validators`` at the first slot of an epoch, whose
    keys are ``consecutive_pubkeys(s0, n)`` (every key distinct: cycled
    keys would let the ingest lane's dedup collapse a committee), and
    ``n_atts`` single-bit attestations, one from each attester of the
    epoch's first slots in committee order, each signed with its
    attester's own key s0 + v (one native G2 lincomb: H(m) per committee,
    scalar s0 + v per attester).  Every vote has head = target = the anchor
    block.  Consecutive runs of ``batch`` attestations (a slot's, at the
    default sizes) make one wire batch each, in a seeded random order.

    Returns a dict: ``state``, ``spec``, ``s0``, ``anchor_root``,
    ``current_slot`` (the clock: the slot after the last attested one),
    ``batches`` (lists of wire blobs), ``attesters`` (the validator of each
    blob, same nesting), ``shuffle``, ``epoch``, ``points`` (the registry's
    affine pubkeys, for kernel checks), and ``spare``: ``n_spare`` more
    batches from the slots after ``current_slot`` (fresh signatures for
    traced runs; a chain needs its clock at ``spare_slot`` for them)."""
    from lighthouse_tpu_torch.chain.beacon_chain import anchor_block_root
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.ops import native_bls
    from lighthouse_tpu_torch.state_transition import misc
    from lighthouse_tpu_torch.types import AttestationData

    state, spec = build_state(n_validators, seed, "mainnet")
    rng = np.random.default_rng(seed + 1)
    s0 = int(rng.integers(1, 1 << 62))
    pks = consecutive_pubkeys(s0, n_validators)
    state.validators.pubkeys = np.frombuffer(b"".join(pk.to_bytes() for pk in pks),
                                             np.uint8).reshape(n_validators, 48).copy()
    epoch = spec.compute_epoch_at_slot(int(state.slot))
    anchor = anchor_block_root(state, device)
    shuffle = misc.compute_committee_shuffle(state, spec, epoch, device=device)
    per_slot = misc.get_committee_count_per_slot(spec, shuffle.shape[0])
    domain = misc.get_domain(state, spec, spec.domain_beacon_attester, epoch)
    target = Checkpoint(epoch=epoch, root=anchor)
    h_pts = []

    def slot_rows(first_slot: int, n: int) -> tuple[list, int]:
        """(rows (data ssz, committee length, position, validator, H(m) id)
        of the first n attesters from ``first_slot`` on, the next slot)."""
        rows, slot = [], first_slot
        while len(rows) < n:
            for ci in range(per_slot):
                committee = misc.get_beacon_committee(state, spec, slot, ci, shuffle)
                data = AttestationData(slot=slot, index=ci, beacon_block_root=anchor,
                                       source=state.current_justified_checkpoint, target=target)
                h_pts.append(hash_to_g2(misc.compute_signing_root(data.hash_tree_root("cpu"),
                                                                  domain)))
                rows.extend((data.serialize(), committee.shape[0], pos, int(v), len(h_pts) - 1)
                            for pos, v in enumerate(committee))
            slot += 1
        return rows[:n], slot

    rows, current_slot = slot_rows(int(state.slot), n_atts)
    # the slot at current_slot stays unattested (testing.flood_tampered's)
    spare_rows, spare_slot = slot_rows(current_slot + 1, n_spare * batch)
    every = rows + spare_rows
    sigs = native_bls.g2_lincomb_groups(
        [((h_pts[r[4]][0].a, h_pts[r[4]][0].b), (h_pts[r[4]][1].a, h_pts[r[4]][1].b))
         for r in every], [s0 + r[3] for r in every], range(len(every)), len(every))
    blobs = [_attestation_blob(r[0], cv.g2_to_bytes((Fq2(*q[0]), Fq2(*q[1]))), r[1], r[2])
             for r, q in zip(every, sigs)]

    def batched(lo_row: int, hi_row: int) -> tuple[list, list]:
        out, who = [], []
        for lo in range(lo_row, hi_row, batch):
            order = lo + rng.permutation(min(batch, hi_row - lo))
            out.append([blobs[i] for i in order])
            who.append([every[i][3] for i in order])
        return out, who

    batches, attesters = batched(0, len(rows))
    spare, _ = batched(len(rows), len(every))
    return dict(state=state, spec=spec, s0=s0, anchor_root=anchor, current_slot=current_slot,
                batches=batches, attesters=attesters, shuffle=shuffle, epoch=epoch,
                points=[pk.point for pk in pks], spare=spare,
                spare_slot=spare_slot if n_spare else current_slot)


def flood_tampered(cell: dict, n_rows: int = 24) -> tuple[list, dict]:
    """A small batch of the first members of the first two committees of
    ``cell["current_slot"]`` (attesters the flood did not use), with every
    kind of bad row the ingest lane must reject: a signature by another
    key, an undecompressable signature, a wrong target root, an intra-batch
    duplicate, a wrong bits length and a blob that is not SSZ.  Returns
    (blobs, {entry: expected reason}); the other entries must verify."""
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.state_transition import misc
    from lighthouse_tpu_torch.types import AttestationData

    state, spec, s0 = cell["state"], cell["spec"], cell["s0"]
    slot, epoch, anchor = cell["current_slot"], cell["epoch"], cell["anchor_root"]
    domain = misc.get_domain(state, spec, spec.domain_beacon_attester, epoch)
    rows = []                   # [data ssz, signature, committee length, position]
    for ci in (0, 1):
        committee = misc.get_beacon_committee(state, spec, slot, ci, cell["shuffle"])
        for target_root in (anchor, bytes(32)):
            data = AttestationData(slot=slot, index=ci, beacon_block_root=anchor,
                                   source=state.current_justified_checkpoint,
                                   target=Checkpoint(epoch=epoch, root=target_root))
            h = hash_to_g2(misc.compute_signing_root(data.hash_tree_root("cpu"), domain))
            positions = range(n_rows // 2 - 1) if target_root == anchor else [n_rows // 2 - 1]
            rows.extend([data.serialize(), cv.g2_to_bytes(cv.g2_mul(h, s0 + int(committee[pos]))),
                         committee.shape[0], pos] for pos in positions)
    half = n_rows // 2
    want = {half - 1: "unknown_target_root", n_rows - 1: "unknown_target_root",
            1: "invalid_signature", half + 1: "invalid_signature"}
    rows[1][1] = rows[2][1]                                  # row 2's signature on row 1
    rows[half + 1][1] = b"\x00" + rows[half + 1][1][1:]     # compression flag cleared
    blobs = [_attestation_blob(*r) for r in rows]
    blobs.append(blobs[0])                                   # a duplicate of row 0
    want[len(blobs) - 1] = "duplicate_in_batch"
    data_ssz, sig, length, _pos = rows[4]
    blobs.append(_attestation_blob(data_ssz, sig, length - 1, 0))
    want[len(blobs) - 1] = "aggregation_bits_length"
    blobs.append(b"\x00\x01\x02")
    want[len(blobs) - 1] = "decode_error"
    return blobs, want


def ceremony_dict(settings, tau: int = 0x123456789ABCDEF, n_g2: int = 65) -> dict:
    """``settings`` (a ``KzgSettings.dev`` setup from ``tau``) in the
    ceremony file's format: ``g1_lagrange`` in natural order and
    ``g2_monomial`` = [τ^i]·G2 for i < ``n_g2``, compressed hex."""
    from lighthouse_tpu_torch.crypto.kzg import _bit_reversal_permutation
    from lighthouse_tpu_torch.ops import native_bls

    g2 = cv.g2_generator()
    pows = [pow(tau, i, GROUP_R) for i in range(n_g2)]
    g2_pts = native_bls.g2_lincomb_groups(
        [((g2[0].a, g2[0].b), (g2[1].a, g2[1].b))] * n_g2, pows, range(n_g2), n_g2)
    return {
        "g1_lagrange": ["0x" + cv.g1_to_bytes(p).hex()
                        for p in _bit_reversal_permutation(settings.g1_lagrange_brp)],
        "g2_monomial": ["0x" + cv.g2_to_bytes((Fq2(*q[0]), Fq2(*q[1]))).hex() for q in g2_pts],
    }


def non_g1_point(seed: int):
    """A point of E(Fq) outside G1: a random curve point, which carries a
    cofactor component."""
    rng = np.random.default_rng(seed)
    while True:
        x = int.from_bytes(rng.bytes(48), "big") % FIELD_P
        rhs = (x * x * x + 4) % FIELD_P
        y = pow(rhs, (FIELD_P + 1) // 4, FIELD_P)
        if y * y % FIELD_P == rhs and not cv.g1_in_subgroup((x, y)):
            return x, y


# a point of order 3 of E(Fq): (0, ±2) (x = 0 points are the curve's
# inflection points)
ORDER3_G1 = (0, 2)


# --------------------------------------------------------------------------
# full Deneb blocks with real signatures (BASELINE config 2)
# --------------------------------------------------------------------------

class BlockProducer:
    """Makes full, validly signed Deneb blocks on a state whose validator i
    holds the secret scalar ``s0 + i``: the block-making part of the JAX
    package's ``Harness`` (``lighthouse_tpu/testing.py:124-335``:
    ``produce_block``, ``_sync_aggregate``, ``_execution_payload``,
    ``attest``).  Aggregates are one ``sign`` with the members' summed
    scalars (``_aggregate_sign``); post-state roots come from a trial
    ``process_block`` with NO_VERIFICATION, as ``produce_block`` does.
    ``state`` is the producer's own copy, moved to each block's post-state;
    ``device`` runs the shuffles and state roots."""

    def __init__(self, state, spec, s0: int, device=None):
        from lighthouse_tpu_torch.device import resolve_device

        self.state, self.spec, self.s0 = state, spec, s0
        self.device = resolve_device(device)
        self.t = make_types(spec.preset)
        self._shuffles: dict = {}

    def sk(self, validator_index: int) -> int:
        return self.s0 + int(validator_index)

    def _sign(self, state, sk_sum: int, obj_root: bytes, domain_type: int, epoch: int) -> bytes:
        from lighthouse_tpu_torch.state_transition import misc

        domain = misc.get_domain(state, self.spec, domain_type, epoch)
        return _aggregate_sign(sk_sum, misc.compute_signing_root(obj_root, domain)).to_bytes()

    def shuffle(self, state, epoch: int) -> np.ndarray:
        from lighthouse_tpu_torch.state_transition import misc

        seed = misc.get_seed(state, self.spec, epoch, self.spec.domain_beacon_attester)
        if (epoch, seed) not in self._shuffles:
            self._shuffles[(epoch, seed)] = misc.compute_committee_shuffle(
                state, self.spec, epoch, device=self.device)
        return self._shuffles[(epoch, seed)]

    def attest(self, state, slot: int, committee_index: int):
        """The whole committee's aggregate attestation at ``slot`` (before
        ``state.slot``) to the head ``state`` saw then."""
        from lighthouse_tpu_torch.state_transition import misc
        from lighthouse_tpu_torch.types import AttestationData

        spec = self.spec
        epoch = spec.compute_epoch_at_slot(slot)
        committee = misc.get_beacon_committee(state, spec, slot, committee_index,
                                              self.shuffle(state, epoch))
        source = (state.current_justified_checkpoint if epoch == misc.current_epoch(state, spec)
                  else state.previous_justified_checkpoint)
        data = AttestationData(slot=slot, index=committee_index,
                               beacon_block_root=misc.get_block_root_at_slot(state, spec, slot),
                               source=source,
                               target=Checkpoint(epoch=epoch,
                                                 root=misc.get_block_root(state, spec, epoch)))
        sig = self._sign(state, sum(self.sk(v) for v in committee), data.hash_tree_root("cpu"),
                         spec.domain_beacon_attester, epoch)
        return self.t.Attestation(aggregation_bits=[True] * committee.shape[0], data=data,
                                  signature=sig)

    def _sync_aggregate(self, pre, slot: int):
        from lighthouse_tpu_torch.state_transition import misc
        from lighthouse_tpu_torch.state_transition.block_processing import (
            sync_committee_validator_indices,
        )

        prev_slot = max(slot, 1) - 1
        members = sync_committee_validator_indices(pre)
        sig = self._sign(pre, sum(self.sk(v) for v in members),
                         misc.get_block_root_at_slot(pre, self.spec, prev_slot),
                         self.spec.domain_sync_committee,
                         self.spec.compute_epoch_at_slot(prev_slot))
        return self.t.SyncAggregate(sync_committee_bits=[True] * len(members),
                                    sync_committee_signature=sig)

    def _execution_payload(self, pre, slot: int):
        from lighthouse_tpu_torch.state_transition import misc
        from lighthouse_tpu_torch.state_transition.block_processing import (
            get_expected_withdrawals,
        )

        spec = self.spec
        parent_hash = bytes(pre.latest_execution_payload_header.block_hash)
        return self.t.ExecutionPayloadDeneb(
            parent_hash=parent_hash,
            prev_randao=misc.get_randao_mix(pre, spec, spec.compute_epoch_at_slot(slot)),
            block_number=slot, timestamp=int(pre.genesis_time) + slot * spec.seconds_per_slot,
            block_hash=hashlib.sha256(parent_hash + slot.to_bytes(8, "little")).digest(),
            withdrawals=get_expected_withdrawals(pre, spec))

    def produce_block(self, slot: int | None = None, attestations=None):
        """A signed block at ``slot`` (default: the next slot) carrying
        ``attestations`` (default: every committee of the two slots before
        it), the full sync aggregate, the randao reveal and the proposer's
        signature.  Returns ``(signed_block, pre, post)``: the producer's
        state advanced to the slot, and after the block (the producer's
        state from now on)."""
        from lighthouse_tpu_torch.state_transition import misc
        from lighthouse_tpu_torch.state_transition.block_processing import (
            SignatureStrategy,
            process_block,
        )
        from lighthouse_tpu_torch import ssz
        from lighthouse_tpu_torch.state_transition.slot_processing import state_advance

        spec, t = self.spec, self.t
        target = int(self.state.slot) + 1 if slot is None else slot
        pre = self.state.copy()
        state_advance(pre, spec, target, self.device)
        epoch = spec.compute_epoch_at_slot(target)
        if attestations is None:
            per_slot = misc.get_committee_count_per_slot(
                spec, self.shuffle(pre, epoch).shape[0])
            attestations = [self.attest(pre, s, ci) for s in (target - 2, target - 1)
                            for ci in range(per_slot)]
        proposer = misc.get_beacon_proposer_index(pre, spec)
        body = t.BeaconBlockBodyDeneb(
            randao_reveal=self._sign(pre, self.sk(proposer),
                                     ssz.uint64.hash_tree_root(epoch, "cpu"),
                                     spec.domain_randao, epoch),
            eth1_data=pre.eth1_data, graffiti=b"lighthouse-tpu".ljust(32, b"\x00"),
            attestations=list(attestations), sync_aggregate=self._sync_aggregate(pre, target),
            execution_payload=self._execution_payload(pre, target))
        block = t.BeaconBlockDeneb(slot=target, proposer_index=proposer,
                                   parent_root=pre.latest_block_header.hash_tree_root("cpu"),
                                   state_root=b"\x00" * 32, body=body)
        post = pre.copy()
        process_block(post, spec, t.SignedBeaconBlockDeneb(message=block),
                      SignatureStrategy.NO_VERIFICATION, shuffle_fn=self.shuffle,
                      device=self.device)
        block.state_root = post.hash_tree_root(self.device)
        sig = self._sign(pre, self.sk(proposer), block.hash_tree_root(self.device),
                         spec.domain_beacon_proposer, epoch)
        self.state = post
        return t.SignedBeaconBlockDeneb(message=block, signature=sig), pre, post


    def resign(self, block):
        """The block signed by the validator it names as proposer (tampered
        blocks whose only fault is inside)."""
        epoch = self.spec.compute_epoch_at_slot(int(block.slot))
        sig = self._sign(self.state, self.sk(int(block.proposer_index)),
                         block.hash_tree_root(self.device), self.spec.domain_beacon_proposer, epoch)
        return self.t.SignedBeaconBlockDeneb(message=block, signature=sig)


def tampered_blocks(cell: dict) -> dict:
    """Copies of ``cell["blocks"][0]``, each signed by its named proposer,
    with one fault and the ``BlockError`` reason the chain must give:
    two attestations' signatures swapped (``batch_signature_invalid``), a
    wrong state root (``state_root_mismatch``), the next validator named as
    proposer (``incorrect_proposer``)."""
    producer, good = cell["producer"], cell["blocks"][0].message
    n = len(cell["state"].validators)

    def variant(edit):
        block = good.copy()
        edit(block)
        return producer.resign(block)

    def swap(b):
        atts = b.body.attestations
        atts[0].signature, atts[1].signature = atts[1].signature, atts[0].signature

    return {
        "batch_signature_invalid": variant(swap),
        "state_root_mismatch": variant(lambda b: setattr(b, "state_root", b"\x11" * 32)),
        "incorrect_proposer": variant(
            lambda b: setattr(b, "proposer_index", (int(b.proposer_index) + 1) % n)),
    }


def block_cell(n_validators: int = 1 << 20, seed: int = 12, n_blocks: int = 2,
               device=None) -> dict:
    """BASELINE config 2 on the port: a mainnet-preset Deneb state of
    ``n_validators`` whose registry keys are
    ``consecutive_pubkeys(s0, n)``, with ``n_blocks`` consecutive full
    blocks on it (``BlockProducer``: at 2^20 validators, 128 aggregate
    attestations over the 64 committees of 512 of each of the two slots
    before the block, the full sync aggregate, randao and proposal: 131
    signature sets over 66,050 member keys).

    The state is ``build_state``'s at the first slot of an epoch, with its
    sync committees drawn from the registry (with replacement, as the
    spec's sample may repeat), nine tenths of the validators on 0x01
    credentials with a little excess balance (so that blocks carry a full
    withdrawals sweep, as mainnet blocks do), and the tree cache attached
    on ``device``.  The first block is at slot + 2, so its attestations
    cover two whole slots of the same epoch.  The registry's key objects
    are interned with their points (``PublicKey.intern_decompressed``): a
    node holds its registry's keys decompressed, and the verifier then
    pays no host decompression for them.

    Returns a dict: ``state`` (the anchor), ``spec``, ``s0``, ``blocks``,
    ``pre_states`` (each block's parent state advanced to its slot, cache
    attached), ``post_roots``, ``anchor_root``, ``sync_indices``, and
    ``keygen_s`` (the host seconds of the key column)."""
    import time

    from lighthouse_tpu_torch.chain.beacon_chain import anchor_block_root
    from lighthouse_tpu_torch.ssz.tree_cache import enable_tree_cache

    state, spec = build_state(n_validators, seed)
    rng = np.random.default_rng(seed + 1)
    s0 = int(rng.integers(1, 1 << 62))
    t0 = time.perf_counter()
    pks = consecutive_pubkeys(s0, n_validators)
    bls.PublicKey.intern_decompressed(pks)
    state.validators.pubkeys = np.frombuffer(b"".join(pk.to_bytes() for pk in pks),
                                             np.uint8).reshape(n_validators, 48)
    keygen_s = time.perf_counter() - t0
    eth1 = rng.random(n_validators) < 0.9
    creds = state.validators.withdrawal_credentials
    creds[eth1, 0] = 0x01
    creds[eth1, 1:12] = 0
    state.balances[eth1] += rng.integers(1, 10**8, int(eth1.sum())).astype(np.uint64)
    t = make_types(spec.preset)
    for name in ("current_sync_committee", "next_sync_committee"):
        idx = rng.integers(0, n_validators, spec.preset.sync_committee_size)
        agg = cv.INF
        for i in idx:
            agg = cv.g1_add(agg, pks[int(i)].point)
        setattr(state, name, t.SyncCommittee(pubkeys=[pks[int(i)].to_bytes() for i in idx],
                                             aggregate_pubkey=cv.g1_to_bytes(agg)))
    enable_tree_cache(state, device)
    anchor_root = anchor_block_root(state, device)
    producer = BlockProducer(state.copy(), spec, s0, device)
    blocks, pre_states, post_roots = [], [], []
    for k in range(n_blocks):
        signed, pre, post = producer.produce_block(int(state.slot) + 2 + k)
        blocks.append(signed)
        pre_states.append(pre)
        post_roots.append(bytes(signed.message.state_root))
    return dict(state=state, spec=spec, s0=s0, blocks=blocks, pre_states=pre_states,
                post_roots=post_roots, anchor_root=anchor_root, keygen_s=keygen_s,
                producer=producer)
