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
blobs must reject the same way in both.  A fault inside row 11 must
propagate out of ``process_wire_batch``.
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
from lighthouse_tpu_torch.ops import msm
from lighthouse_tpu_torch.types import ChainSpec, make_types

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


def test_a_row_11_fault_propagates(world, monkeypatch):
    h, blobs = world
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "device")
    pubkey_plane.reset_pubkey_plane("cpu")

    def boom(*a, **k):
        raise RuntimeError("injected row-11 fault")

    monkeypatch.setattr(msm, "gather_fold_plain", boom)
    with pytest.raises(RuntimeError, match="injected row-11 fault"):
        ci.process_wire_batch(_port_chain(h), [(b, False) for b in blobs])


def test_electra_entries_raise(world):
    h, blobs = world
    with pytest.raises(NotImplementedError, match="A 16"):
        ci.process_wire_batch(_port_chain(h), [(blobs[0], True)])


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
