"""The port's gossip attestation ingest (``chain/columnar_ingest.py``
``process_wire_batch``) against the JAX package's, on the CPU.

Both packages build a chain on the same Deneb genesis state of the JAX
package's ``Harness(64, fork="deneb", real_crypto=True)`` (the port's state
carried over by SSZ), with the clock at slot 1, and take the same wire
batch: every committee member's single-bit attestation of slot 0, signed
with the interop keys, plus the bad rows of the smoke run's tampered batch
(a signature by another key, an undecompressable signature, a wrong
target root, an intra-batch duplicate, a wrong bits length, garbage).  Both
verify on the reference BLS backend, so both pre-merge each committee's
sets; the port runs with its pubkey plane forced to the device rung (row
11's plain version on the CPU) and to the reference rung.  The verified
count, the (entry, reason) rejects, the naive pool, the observed attesters
and the fork-choice votes must be equal, and a second pass of the same
blobs must reject the same way in both, with no fault caught on the way.
An error inside row 11 that is not a device fault (a bug) propagates out
of ``process_wire_batch``.  A device fault inside row 11, in the fold and
in the native signature MSM is each recovered (the plane's reference rung,
unmerged lanes, host point arithmetic) with the same verdicts, and counted
in the BLS supervisor's ``faults()`` and ``recoveries()``.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu import types as JT
from lighthouse_tpu.chain import columnar_ingest as jci
from lighthouse_tpu.chain.beacon_chain import BeaconChain as JaxChain
from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.state_transition import misc as jmisc
from lighthouse_tpu.testing import Harness
from lighthouse_tpu_torch.chain import columnar_ingest as ci
from lighthouse_tpu_torch.chain import pubkey_plane
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.crypto.bls import api as pbls
from lighthouse_tpu_torch.ops import faults, msm, native_bls
from lighthouse_tpu_torch.types import ChainSpec, make_types
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

SLOT = 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def world():
    """The JAX harness, the wire batch and the expected bad rows."""
    old = jbls.get_backend()
    jbls.set_backend("reference")
    h = Harness(n_validators=64, fork="deneb", real_crypto=True)
    spec = h.spec
    state = h.state
    epoch = spec.compute_epoch_at_slot(SLOT)
    shuffle = jmisc.compute_committee_shuffle(state, spec, epoch)
    per_slot = jmisc.get_committee_count_per_slot(spec, shuffle.shape[0])
    head = JaxChain._anchor_block_root(state)
    domain = jmisc.get_domain(state, spec, spec.domain_beacon_attester, epoch)
    atts = []
    for ci_ in range(per_slot):
        committee = jmisc.get_beacon_committee(state, spec, SLOT, ci_, shuffle)
        for target_root in (head, b"\x5a" * 32):
            data = JT.AttestationData(slot=SLOT, index=ci_, beacon_block_root=head,
                                      source=state.current_justified_checkpoint,
                                      target=JT.Checkpoint(epoch=epoch, root=target_root))
            root = jmisc.compute_signing_root(data.hash_tree_root(), domain)
            members = range(committee.shape[0]) if target_root == head else range(1)
            for pos in members:
                bits = [False] * committee.shape[0]
                bits[pos] = True
                atts.append(h.t.Attestation(aggregation_bits=bits, data=data,
                                            signature=h.sk(int(committee[pos])).sign(root)
                                            .to_bytes()))
    blobs = [a.serialize() for a in atts]
    sig = bytearray(blobs[1])
    sig[-97:-1] = blobs[2][-97:-1]                      # row 2's signature on row 1
    blobs[1] = bytes(sig)
    broken = bytearray(blobs[6])
    broken[-97] = 0x00                                  # compression flag cleared
    blobs[6] = bytes(broken)
    blobs.append(blobs[0])                              # an intra-batch duplicate
    short = atts[3]
    blobs.append(h.t.Attestation(aggregation_bits=list(short.aggregation_bits)[1:],
                                 data=short.data, signature=short.signature).serialize())
    blobs.append(b"\x00\x01\x02")
    yield h, blobs
    jbls.set_backend(old)


def _jax_chain(h):
    c = JaxChain(h.spec, h.state.copy(), verify_signatures=True)
    c.slot_clock.set_slot(SLOT + 1)
    return c


def _port_chain(h):
    spec = ChainSpec.minimal().with_forks_at(0, "deneb")
    c = BeaconChain(spec, state_from_ssz(h.state.serialize()), bls_backend="reference",
                    device="cpu")
    c.slot_clock.set_slot(SLOT + 1)
    return c


def _jax_view(c, epoch):
    pool = {(slot, key): (bits.tolist(), [s.to_bytes() for s in sigs])
            for slot, per in c.naive_pool._slots.items()
            for key, (_d, bits, sigs, _ci) in per.items()}
    seen = np.nonzero(c.observed_attesters._by_epoch.get(epoch, np.zeros(0, bool)))[0]
    fc = c.fork_choice
    queued = [(q.slot, tuple(np.sort(q.indices).tolist()), q.root, q.target_epoch)
              for q in fc._queued]
    return pool, seen.tolist(), fc._vote_next.tolist(), fc._vote_next_epoch.tolist(), queued


def _port_view(c, epoch):
    node, ep, queued = c.fork_choice.votes()
    return (c.naive_pool.snapshot(), c.observed_attesters.seen_indices(epoch).tolist(),
            node.tolist(), ep.tolist(), queued)


@pytest.fixture(scope="module")
def jax_run(world):
    h, blobs = world
    c = _jax_chain(h)
    first = jci.process_wire_batch(c, [(b, False) for b in blobs])
    second = jci.process_wire_batch(c, [(b, False) for b in blobs])
    return first, second, _jax_view(c, 0)


@pytest.mark.usefixtures("no_recovery")
@pytest.mark.parametrize("rung", ["device", "reference"])
def test_wire_batch_matches_the_jax_package(world, jax_run, rung, monkeypatch):
    h, blobs = world
    jfirst, jsecond, jview = jax_run
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", rung)
    plane = pubkey_plane.reset_pubkey_plane("cpu")
    c = _port_chain(h)
    first = ci.process_wire_batch(c, [(b, False) for b in blobs])
    assert plane.folds[rung] == 1 and plane.folds[{"device": "reference",
                                                   "reference": "device"}[rung]] == 0
    assert first.verified == jfirst.verified == len(blobs) - 7
    assert sorted(first.rejects) == sorted(jfirst.rejects)
    assert dict(first.rejects) == {1: "invalid_signature", 4: "unknown_target_root",
                                   6: "invalid_signature", 9: "unknown_target_root",
                                   10: "duplicate_in_batch", 11: "aggregation_bits_length",
                                   12: "decode_error"}
    second = ci.process_wire_batch(c, [(b, False) for b in blobs])
    assert second.verified == jsecond.verified == 0
    assert sorted(second.rejects) == sorted(jsecond.rejects)
    assert _port_view(c, 0) == jview


EXPECTED_REJECTS = {1: "invalid_signature", 4: "unknown_target_root", 6: "invalid_signature",
                    9: "unknown_target_root", 10: "duplicate_in_batch",
                    11: "aggregation_bits_length", 12: "decode_error"}


def test_a_row_11_fault_propagates(world, monkeypatch):
    """An error of row 11 that is not a device fault is a bug: it raises
    out of the batch, and nothing is counted or recovered."""
    h, blobs = world
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "device")
    pubkey_plane.reset_pubkey_plane("cpu")

    def boom(*a, **k):
        raise RuntimeError("injected row-11 fault")

    monkeypatch.setattr(msm, "gather_fold_plain", boom)
    counted = pbls.faults(), pbls.recoveries()
    with pytest.raises(RuntimeError, match="injected row-11 fault"):
        ci.process_wire_batch(_port_chain(h), [(b, False) for b in blobs])
    assert (pbls.faults(), pbls.recoveries()) == counted


def test_a_row_11_device_fault_is_recovered_and_counted(world, monkeypatch):
    """A device fault of row 11 goes to the supervisor's counters, not to
    the caller: the plane folds the batch again on its reference rung, and
    the batch verifies as it does without the fault."""
    h, blobs = world
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "device")
    plane = pubkey_plane.reset_pubkey_plane("cpu")
    pbls.reset_supervisor()

    def boom(*a, **k):
        raise faults.InjectedFault("injected row-11 fault")

    monkeypatch.setattr(msm, "gather_fold_plain", boom)
    faults0, rec0 = pbls.faults(), pbls.recoveries()
    out = ci.process_wire_batch(_port_chain(h), [(b, False) for b in blobs])
    assert out.verified == len(blobs) - 7 and dict(out.rejects) == EXPECTED_REJECTS
    assert plane.folds == {"device": 0, "reference": 1}
    assert pbls.faults().get(("pubkey_device", "raise"), 0) == \
        faults0.get(("pubkey_device", "raise"), 0) + 1
    assert pbls.recoveries().get("pubkey_plane", 0) == rec0.get("pubkey_plane", 0) + 1
    pbls.reset_supervisor()


def _break(where, plane, monkeypatch, exc):
    def boom(*a, **k):
        raise exc

    if where == "fold_lanes":
        monkeypatch.setattr(plane, "fold", boom)
    else:
        monkeypatch.setattr(native_bls, "g2_lincomb_groups", boom)


@pytest.mark.parametrize("where", ["fold_lanes", "sig_accs"])
def test_fold_and_signature_msm_faults_are_recovered_and_counted(world, where, monkeypatch):
    """A fold that faults leaves its lanes unmerged, and a native signature
    MSM that faults gives way to host point arithmetic: the same verdicts,
    one recovery counted each."""
    h, blobs = world
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "reference")
    plane = pubkey_plane.reset_pubkey_plane("cpu")
    _break(where, plane, monkeypatch, faults.InjectedFault(f"injected {where} fault"))
    rec0 = pbls.recoveries().get(where, 0)
    out = ci.process_wire_batch(_port_chain(h), [(b, False) for b in blobs])
    assert out.verified == len(blobs) - 7 and dict(out.rejects) == EXPECTED_REJECTS
    assert pbls.recoveries().get(where, 0) == rec0 + 1


@pytest.mark.parametrize("where", ["fold_lanes", "sig_accs"])
def test_a_bug_in_the_fold_or_signature_msm_raises(world, where, monkeypatch):
    """Only a device fault is recovered: a TypeError of either call (a bug
    of the calling code) raises out of the batch, and nothing is counted."""
    h, blobs = world
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "reference")
    plane = pubkey_plane.reset_pubkey_plane("cpu")
    _break(where, plane, monkeypatch, TypeError(f"a bug in {where}"))
    counted = pbls.faults(), pbls.recoveries()
    with pytest.raises(TypeError, match=f"a bug in {where}"):
        ci.process_wire_batch(_port_chain(h), [(b, False) for b in blobs])
    assert (pbls.faults(), pbls.recoveries()) == counted


def test_electra_entries_raise(world):
    h, blobs = world
    with pytest.raises(NotImplementedError, match="A 16"):
        ci.process_wire_batch(_port_chain(h), [(blobs[0], True)])


@pytest.mark.usefixtures("no_recovery")
def test_the_flood_cell_verifies_and_its_tampered_batch_rejects(monkeypatch):
    """``testing.flood_cell`` and ``flood_tampered`` at a small size (the
    smoke run's cell is 65,536 validators): every attestation verifies
    through the pre-merge with row 11's plain version, the blobs are the
    containers' SSZ, and the tampered batch rejects entry by entry on
    both of the plane's rungs."""
    from lighthouse_tpu_torch import testing as T

    cell = T.flood_cell(8192, 256, seed=3, batch=256, device="cpu")
    attestation = make_types(cell["spec"].preset).Attestation
    blob = cell["batches"][0][5]
    assert attestation.deserialize(blob).serialize() == blob
    blobs, want = T.flood_tampered(cell, 8)
    for rung in ("device", "reference"):
        monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", rung)
        plane = pubkey_plane.reset_pubkey_plane("cpu")
        c = BeaconChain(cell["spec"], cell["state"], bls_backend="reference", device="cpu")
        c.slot_clock.set_slot(cell["current_slot"])
        if rung == "device":
            r = ci.process_wire_batch(c, [(b, False) for b in cell["batches"][0]])
            assert (r.verified, r.rejects) == (256, [])
            assert plane.folds == {"device": 1, "reference": 0}
            assert sorted(c.observed_attesters.seen_indices(cell["epoch"]).tolist()) == \
                sorted(cell["attesters"][0])
        r = ci.process_wire_batch(c, [(b, False) for b in blobs])
        assert dict(r.rejects) == want and r.verified == len(blobs) - len(want)
