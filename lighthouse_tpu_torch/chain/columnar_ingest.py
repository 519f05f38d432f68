"""Columnar attestation ingest: wire columns -> fork choice and the pools.

Port of ``lighthouse_tpu/chain/columnar_ingest.py`` for the phase0 ...
Deneb wire layout.  The vectorised twin of
``BeaconChain.verify_attestations_for_gossip`` for the single-bit gossip
firehose: where the scalar lane pays Python per message, this lane pays per
group (one distinct AttestationData: slot, committee index, head root) and
numpy per row.

- timing and structure checks are vector masks over the decoded columns;
- signing root, domain, committee and fork-choice ancestry resolve once
  per group;
- attesters come from the aggregation-bit column and the committee array,
  duplicates from one ``seen_mask`` sweep per group;
- on a host BLS backend (``reference``) each signing-root lane with several
  sets folds into ONE blinded merged set: the signature side Σ rᵢ·sigᵢ in
  one native segment MSM, the pubkey side through the pubkey plane (row 11
  on the card when its device rung is armed).  On the ``cuda`` backend the
  fused verify pipeline groups same-message lanes itself, so there is no
  pre-merge (``_should_premerge``), as the JAX rule is for its device
  backends;
- containers are built only for the rows that need one.

Semantics are the scalar lane's: the same reject vocabulary, dup caches
read before signature verification and claimed under the commit lock
after it, a failed fast path bisected over the ORIGINAL per-row sets, and a
lane whose signature resists (undecompressable, infinity, outside G2) or
whose aggregate is the identity passes through UNMERGED.  A device fault
raises: the JAX package's recoveries (a failed fold turned into unmerged
lanes, the host fallback of the signature MSM) are not ported.
"""

from __future__ import annotations

import secrets
import threading
import time

import numpy as np

from lighthouse_tpu_torch.chain import attestation_verification as att_verify
from lighthouse_tpu_torch.chain import pubkey_plane
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import R as _R
from lighthouse_tpu_torch.ops import native_bls
from lighthouse_tpu_torch.pool import pre_aggregation
from lighthouse_tpu_torch.ssz import columnar
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.types import AttestationData

# slots and epochs beyond 2^62 are adversarial counters that would overflow
# the int64 vector math; the scalar lane rejects them on the same checks
_SANE = np.uint64(1 << 62)

_STAGE_LOCK = threading.Lock()
_STAGE_SECONDS: dict[str, float] = {}
_STAGE_COUNTS: dict[str, int] = {}


def _stage(key: str, seconds: float, count: int = 0) -> None:
    with _STAGE_LOCK:
        _STAGE_SECONDS[key] = _STAGE_SECONDS.get(key, 0.0) + seconds
        if count:
            _STAGE_COUNTS[key] = _STAGE_COUNTS.get(key, 0) + count


def stage_snapshot() -> dict:
    """Cumulative wall seconds and counts per stage (decode, prepare,
    pubkey_fold, verify, commit)."""
    with _STAGE_LOCK:
        return {"seconds": dict(_STAGE_SECONDS), "counts": dict(_STAGE_COUNTS)}


def reset_stages() -> None:
    with _STAGE_LOCK:
        _STAGE_SECONDS.clear()
        _STAGE_COUNTS.clear()


class WireBatchResult:
    """Outcome of one wire batch; indices name the caller's ``entries``."""

    __slots__ = ("n", "verified", "rejects")

    def __init__(self, n: int):
        self.n = n
        self.verified = 0
        self.rejects: list[tuple[int, str]] = []     # (entry, reason)


def process_wire_batch(chain, entries: list[tuple[bytes, bool]]) -> WireBatchResult:
    """The wire seam: ``entries`` is one admission batch of ``(blob,
    electra)`` pairs.  Blobs are decoded in one strided parse, the columnar
    lane verifies and commits the rows it takes, and only the rows it
    cannot take (strided-parse rejects, explicit fallback rows) pay the
    scalar lane.  A blob the scalar deserialize refuses rejects as
    ``decode_error``."""
    if any(e for _b, e in entries):
        raise NotImplementedError("Electra attestations are not ported (ROADMAP A 16)")
    out = WireBatchResult(len(entries))
    cls = chain.t.Attestation
    t0 = time.perf_counter()
    cols, malformed = columnar.decode_batch([b for b, _e in entries],
                                            columnar.layout_for(chain.spec.preset), cls=cls)
    _stage("decode", time.perf_counter() - t0, len(entries))
    scalar_items: list[tuple[int, object]] = []
    for j in malformed:
        try:
            scalar_items.append((j, cls.deserialize(entries[j][0])))
        except Exception:           # any refusal of the scalar decoder is the verdict
            out.rejects.append((j, "decode_error"))
    outcome = ingest_attestation_columns(chain, cols)
    out.verified += len(outcome.verified_rows)
    for row, reason in outcome.rejects:
        out.rejects.append((int(cols.row_index[row]), reason))
    for row in outcome.fallback_rows:
        scalar_items.append((int(cols.row_index[row]), cols.materialize(row)))
    if scalar_items:
        entry_of = {id(obj): i for i, obj in scalar_items}
        verified, rejects = chain.verify_attestations_for_gossip([o for _i, o in scalar_items])
        out.verified += len(verified)
        for item, reason in rejects:
            out.rejects.append((entry_of.get(id(item), -1), reason))
    return out


class _Group:
    __slots__ = ("gid", "rows", "data", "data_root", "signing_root", "committee",
                 "committee_index", "epoch", "slot")

    def __init__(self, gid):
        self.gid = gid


class IngestOutcome:
    """Per-row outcomes of one columnar sweep (rows index the batch)."""

    __slots__ = ("n", "verified_rows", "rejects", "fallback_rows")

    def __init__(self, n):
        self.n = n
        self.verified_rows: list[int] = []
        self.rejects: list[tuple[int, str]] = []
        self.fallback_rows: list[int] = []


def ingest_attestation_columns(chain, cols) -> IngestOutcome:
    """One decoded batch through checks -> BLS -> commit.  Prepare and
    commit hold the import lock; the BLS work runs outside it."""
    out = IngestOutcome(cols.n)
    reasons: dict[int, str] = {}
    t0 = time.perf_counter()
    with chain._import_lock:
        prep = _prepare(chain, cols, reasons, out.fallback_rows)
    _stage("prepare", time.perf_counter() - t0, cols.n)
    verdict_of_set = None
    if chain.verify_signatures and prep["n_sets"]:
        verdict_of_set = _verify_sets(chain, prep)
    t0 = time.perf_counter()
    with chain._import_lock:
        _commit(chain, cols, prep, reasons, verdict_of_set, out)
    _stage("commit", time.perf_counter() - t0)
    out.rejects = sorted(reasons.items())
    return out


# -- prepare --------------------------------------------------------------------

def kill_rows(reasons, alive, rows, reason: str) -> None:
    for r in rows:
        reasons[int(r)] = reason
    alive[rows] = False


def _prepare(chain, cols, reasons, fallback_rows):
    spec = chain.spec
    n = cols.n
    alive = np.ones(n, bool)

    def kill(mask, reason):
        kill_rows(reasons, alive, np.nonzero(mask & alive)[0], reason)

    # an insane slot IS a future slot; an insane target epoch on a sane slot
    # passes the slot window and fails the epoch compare, as in the scalar
    # lane's Python-int checks
    insane_slot = cols.slot > _SANE
    insane_tgt = cols.target_epoch > _SANE
    kill(insane_slot, "future_slot")
    slot64 = np.where(insane_slot, 0, cols.slot.astype(np.int64))
    target64 = cols.target_epoch.astype(np.int64)
    cur = chain.current_slot()
    kill(slot64 > cur, "future_slot")
    kill(slot64 + spec.slots_per_epoch < cur, "past_slot")
    kill(insane_tgt | (target64 != slot64 // spec.slots_per_epoch), "target_epoch_mismatch")
    # empty / aggregated bits are decided per group AFTER the head and target
    # checks: the scalar lane's order (unknown_head_block outranks them)

    group_of_row, first_rows = cols.group_keys()
    groups: list[_Group] = []
    attester = np.full(n, -1, np.int64)
    proto = chain.fork_choice.proto
    for gid in range(len(first_rows)):
        rows = np.nonzero((group_of_row == gid) & alive)[0]
        if rows.size == 0:
            continue
        g = _Group(gid)
        g.slot = int(slot64[rows[0]])
        g.epoch = int(target64[rows[0]])
        head_root = cols.beacon_block_root[rows[0]].tobytes()
        target_root = cols.target_root[rows[0]].tobytes()
        if head_root not in proto:
            kill_rows(reasons, alive, rows, "unknown_head_block")
            continue
        if target_root not in proto:
            kill_rows(reasons, alive, rows, "unknown_target_root")
            continue
        if proto.get_ancestor(head_root, spec.compute_start_slot_at_epoch(g.epoch)) != target_root:
            kill_rows(reasons, alive, rows, "invalid_target_root")
            continue
        g.data = AttestationData.deserialize(cols.data_raw[rows[0]].tobytes())
        try:
            state = chain._attestation_state(g)
            shuffle = chain.committee_shuffle(state, g.epoch)
            g.committee_index = int(cols.index[rows[0]])
            g.committee = misc.get_beacon_committee(state, spec, g.slot, g.committee_index,
                                                    shuffle)
        except (ValueError, KeyError):
            kill_rows(reasons, alive, rows, "invalid_committee")
            continue
        kill_rows(reasons, alive, rows[cols.bit_count[rows] != g.committee.shape[0]],
                  "aggregation_bits_length")
        rows = rows[cols.bit_count[rows] == g.committee.shape[0]]
        kill_rows(reasons, alive, rows[cols.set_bits[rows] == 0], "empty_aggregation_bits")
        kill_rows(reasons, alive, rows[cols.set_bits[rows] > 1], "not_unaggregated")
        rows = rows[cols.set_bits[rows] == 1]
        if rows.size == 0:
            continue
        attester[rows] = g.committee[cols.first_bit[rows]]
        # pubkeys come from the HEAD registry (index -> pubkey is the same on
        # every branch); an index it does not cover yet takes the scalar lane
        n_reg = len(chain.head_state.validators)
        oob = rows[attester[rows] >= n_reg]
        if oob.size:
            fallback_rows.extend(int(r) for r in oob)
            alive[oob] = False
            rows = rows[attester[rows] < n_reg]
            if rows.size == 0:
                continue
        seen = chain.observed_attesters.seen_mask(g.epoch, attester[rows])
        kill_rows(reasons, alive, rows[seen], "prior_attestation_known")
        rows = rows[~seen]
        if rows.size == 0:
            continue
        g.rows = rows
        g.data_root = g.data.hash_tree_root("cpu")
        domain = misc.get_domain(state, spec, spec.domain_beacon_attester, g.epoch)
        g.signing_root = misc.compute_signing_root(g.data_root, domain)
        groups.append(g)

    # unique signature sets: (group, attester PUBKEY bytes, signature bytes);
    # byte-identical sets verify once
    live_rows = np.concatenate([g.rows for g in groups]) if groups else np.zeros(0, np.int64)
    group_of_live = (np.concatenate([np.full(g.rows.size, i, np.int64)
                                     for i, g in enumerate(groups)])
                     if groups else np.zeros(0, np.int64))
    prep = {"groups": groups, "attester": attester, "live_rows": live_rows,
            "group_of_live": group_of_live, "set_of_live": np.zeros(0, np.int64),
            "set_first": np.zeros(0, np.int64), "n_sets": 0,
            "pk_rows": np.zeros((0, 48), np.uint8), "cols_sig": np.zeros((0, 96), np.uint8)}
    if live_rows.size:
        pk_rows = np.asarray(chain.head_state.validators.pubkeys[attester[live_rows]], np.uint8)
        cols_sig = cols.signature[live_rows]
        key = np.empty((live_rows.size, 8 + 48 + 96), np.uint8)
        key[:, :8] = group_of_live.view(np.uint8).reshape(-1, 8)
        key[:, 8:56] = pk_rows
        key[:, 56:] = cols_sig
        view = np.ascontiguousarray(key).view([("k", "V152")]).ravel()
        _, set_first, set_of_live = np.unique(view, return_index=True, return_inverse=True)
        prep.update(set_of_live=set_of_live.ravel(), set_first=set_first,
                    n_sets=set_first.size, pk_rows=pk_rows, cols_sig=cols_sig)
    return prep


# -- BLS ------------------------------------------------------------------------

def _unique_set(prep, u: int):
    """Unique set ``u`` as a plain SignatureSet (bisection attribution, the
    unmerged pass-through, the ``cuda`` backend's input)."""
    i = int(prep["set_first"][u])
    g = prep["groups"][int(prep["group_of_live"][i])]
    return bls.SignatureSet(bls.Signature.interned(prep["sig_bytes"][u]),
                            [bls.PublicKey.interned(prep["pk_rows"][i].tobytes())],
                            g.signing_root)


def _should_premerge(backend: str) -> bool:
    """Merged host folds are redundant when the card's fused pipeline
    verifies (it groups same-message lanes itself), so only a host backend
    pre-merges; ``LHGPU_PRE_BLS=0`` turns it off too."""
    return pre_aggregation.enabled() and backend != "cuda"


def _verify_sets(chain, prep) -> np.ndarray:
    """Verdict per unique set: the merged fast path, then bisection over
    the original sets."""
    groups, n_sets = prep["groups"], prep["n_sets"]
    set_first, group_of_live = prep["set_first"], prep["group_of_live"]
    prep["sig_bytes"] = [prep["cols_sig"][int(set_first[u])].tobytes() for u in range(n_sets)]
    # merge lanes keyed by signing root
    lane_of_root: dict[bytes, int] = {}
    lane_sets: list[list[int]] = []
    for u in range(n_sets):
        g = groups[int(group_of_live[int(set_first[u])])]
        lane = lane_of_root.setdefault(g.signing_root, len(lane_sets))
        if lane == len(lane_sets):
            lane_sets.append([])
        lane_sets[lane].append(u)
    t0 = time.perf_counter()
    merged, singles, n_folded = [], list(range(n_sets)), 0
    if _should_premerge(chain.bls_backend):
        merged, singles, n_folded = _fold_lanes(chain, prep, lane_sets)
    _stage("pubkey_fold", time.perf_counter() - t0, n_folded)

    t0 = time.perf_counter()
    originals = [_unique_set(prep, u) for u in range(n_sets)]
    bls.PublicKey.decompress_batch([s.pubkeys[0] for s in originals])
    verify_list = merged + [originals[u] for u in singles]
    verdict = np.zeros(n_sets, bool)
    if not verify_list or chain.verify_sets(verify_list):
        verdict[:] = True
    else:           # attribution unchanged: bisect the ORIGINAL per-row sets
        verdict[:] = att_verify.verify_signature_sets_with_bisection(
            originals, backend=chain.bls_backend, device=chain.device)
    _stage("verify", time.perf_counter() - t0, len(verify_list))
    return verdict


def _fold_lanes(chain, prep, lane_sets: list[list[int]]) -> tuple[list, list[int], int]:
    """Blinded merged sets for every signing-root lane of several sets:
    the signature side in one native segment MSM across lanes, the pubkey
    side in ONE pubkey-plane fold across lanes.  A lane that resists passes
    through unmerged."""
    set_first, group_of_live = prep["set_first"], prep["group_of_live"]
    live_rows, attester, groups = prep["live_rows"], prep["attester"], prep["groups"]
    sig_bytes = prep["sig_bytes"]
    singles: list[int] = []
    cand: list[dict] = []
    fold_idx, fold_r, fold_lane = [], [], []
    # ONE batched decompression and G2 membership test across every lane's
    # constituents; the per-lane pass below re-checks only what failed here
    every = sorted({u for m in lane_sets for u in m})
    if every:
        batch_sigs = [bls.Signature.interned(sig_bytes[u]) for u in every]
        bls.Signature.decompress_batch(batch_sigs)      # failures are handled per lane
        bls.Signature.subgroup_check_batch(batch_sigs)
    for members in lane_sets:
        if len(members) == 1:
            singles.append(members[0])
            continue
        lane = _fold_sig_side(prep, members)
        if lane is None:
            singles.extend(members)
            continue
        for u, r in zip(members, lane["blinders"]):
            fold_idx.append(int(attester[int(live_rows[int(set_first[u])])]))
            fold_r.append(r)
            fold_lane.append(len(cand))
        cand.append(lane)
    merged: list = []
    n_folded = 0
    if cand:
        pk_pts = pubkey_plane.get_plane().fold(
            chain.head_state.validators, np.array(fold_idx, np.int64),
            np.array(fold_r, np.uint64), np.array(fold_lane, np.int64), len(cand))
        sig_accs = _sig_accs(cand)
        for lane, pk_pt, sig_acc in zip(cand, pk_pts, sig_accs):
            if pk_pt is None or sig_acc is None:
                singles.extend(lane["members"])
                continue
            g0 = groups[int(group_of_live[int(set_first[lane["members"][0]])])]
            merged.append(bls.SignatureSet(bls.Signature(cv.g2_to_bytes(sig_acc), sig_acc),
                                           [bls.PublicKey(cv.g1_to_bytes(pk_pt), pk_pt)],
                                           g0.signing_root))
            n_folded += len(lane["members"])
    return merged, singles, n_folded


def _fold_sig_side(prep, members: list[int]):
    """The blinders and the collapsed signature terms (Σ rᵢ per unique
    signature) of one lane, or None when a constituent resists."""
    sig_bytes = prep["sig_bytes"]
    sigs = [bls.Signature.interned(sig_bytes[u]) for u in members]
    if not bls.Signature.decompress_batch(sigs):
        return None
    blinders: list[int] = []
    sig_sums: dict[bytes, tuple[int, object]] = {}
    for u, sig in zip(members, sigs):
        pt = sig.point_unchecked()
        if pt is cv.INF:
            return None
        # the merged Signature carries a preset point, which verifiers trust
        # as checked: complete the G2 membership test here, or a small-order
        # forgery could fold in unchecked
        if not sig.subgroup_checked():
            if not cv.g2_in_subgroup_fast(pt):
                return None
            sig.mark_subgroup_checked()
        r = 0
        while r == 0:
            r = secrets.randbits(64)
        blinders.append(r)
        prev = sig_sums.get(sig_bytes[u])
        sig_sums[sig_bytes[u]] = ((prev[0] + r) % _R if prev else r, pt)
    terms = [(pt, s) for s, pt in sig_sums.values() if s]
    if not terms:
        return None
    return {"members": members, "blinders": blinders, "terms": terms}


def _sig_accs(cand: list[dict]) -> list:
    """Σ rᵢ·sigᵢ per lane in one native segment MSM; None for an identity
    sum (such a merged set can never verify: the lane goes unmerged)."""
    pts, scalars, gids = [], [], []
    for lane_id, lane in enumerate(cand):
        for pt, s in lane["terms"]:
            pts.append(((pt[0].a, pt[0].b), (pt[1].a, pt[1].b)))
            scalars.append(s)
            gids.append(lane_id)
    res = native_bls.g2_lincomb_groups(pts, scalars, gids, len(cand))
    return [None if v is None else (cv.Fq2(*v[0]), cv.Fq2(*v[1])) for v in res]


# -- commit ---------------------------------------------------------------------

def _commit(chain, cols, prep, reasons, verdict_of_set, out) -> None:
    live_rows, attester = prep["live_rows"], prep["attester"]
    if live_rows.size == 0:
        return
    ok_live = (np.ones(live_rows.size, bool) if verdict_of_set is None
               else np.asarray(verdict_of_set)[prep["set_of_live"]])
    live_pos_of_row = {int(r): i for i, r in enumerate(live_rows)}
    for g in prep["groups"]:
        rows = g.rows
        ok_rows = ok_live[np.array([live_pos_of_row[int(r)] for r in rows], np.int64)]
        for r in rows[~ok_rows]:
            reasons[int(r)] = "invalid_signature"
        rows = rows[ok_rows]
        if rows.size == 0:
            continue
        # claim the dup marks under the commit lock: duplicates inside the
        # batch first (arrival order wins), then the cache
        order = np.argsort(rows, kind="stable")
        rows_o, idx_o = rows[order], attester[rows[order]]
        _uniq, first_pos = np.unique(idx_o, return_index=True)
        keep = np.zeros(rows_o.size, bool)
        keep[first_pos] = True
        for r in rows_o[~keep]:
            reasons[int(r)] = "duplicate_in_batch"
        rows_o, idx_o = rows_o[keep], idx_o[keep]
        already = chain.observed_attesters.observe_batch(g.epoch, idx_o)
        for r in rows_o[already]:
            reasons[int(r)] = "duplicate_in_batch"
        rows_o, idx_o = rows_o[~already], idx_o[~already]
        if rows_o.size == 0:
            continue
        chain.apply_votes(idx_o, cols.beacon_block_root[rows_o[0]].tobytes(), g.epoch, g.slot)
        committee_len = int(g.committee.shape[0])
        for r in rows_o:
            chain.naive_pool.insert_single_bit(g.data, g.data_root, g.committee_index,
                                               committee_len, int(cols.first_bit[r]),
                                               cols.signature[r].tobytes())
        chain.validator_monitor.on_gossip_attestation(idx_o, g.data, chain.spec)
        out.verified_rows.extend(int(r) for r in rows_o)
