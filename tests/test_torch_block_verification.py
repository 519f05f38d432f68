"""The port's block import (``chain/block_verification.py`` and
``BeaconChain.process_block``) against the JAX chain's, on the CPU.

Both chains are anchored at the same Deneb genesis state of the JAX
package's ``Harness(64, fork="deneb")`` (the port's carried over by SSZ)
and import the same blocks.  They must return the same block roots, hold
the same fork-choice nodes (parent, slot, justified, finalized and
unrealized checkpoint epochs), the same store checkpoints and the same
votes from the blocks' attestations, and reject the same bad blocks with
the same ``BlockError`` reasons.  The long run uses fake signatures with
signature checks off in both chains; a real-signature run checks the
gossip stage's proposer batch and the block batch, the JAX side on its
reference backend, the port's on its own (the ``cuda`` backend's plain
versions on the CPU are covered by ``tests/test_torch_block.py``).
"""

import copy

import pytest
import torch

from lighthouse_tpu.chain.beacon_chain import BeaconChain as JaxChain
from lighthouse_tpu.chain.block_verification import BlockError as JaxBlockError
from lighthouse_tpu.crypto.bls import api as jbls
from lighthouse_tpu.state_transition import misc as jmisc
from lighthouse_tpu.testing import Harness
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
from lighthouse_tpu_torch.chain.block_verification import BlockError
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.types import ChainSpec, make_types
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")

CPU = "cpu"
SPEC = ChainSpec.minimal().with_forks_at(0, "deneb")
TYPES = make_types(SPEC.preset)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_backend():
    old = jbls.get_backend()
    jbls.set_backend("reference")
    yield
    jbls.set_backend(old)


def _chains(h, verify: bool, backend: str = "reference"):
    j = JaxChain(h.spec, h.state.copy(), verify_signatures=verify)
    p = BeaconChain(SPEC, state_from_ssz(h.state.serialize()), bls_backend=backend, device=CPU,
                    verify_signatures=verify)
    assert p.anchor_root == j.genesis_block_root
    return j, p


def _port(signed):
    return TYPES.SignedBeaconBlockDeneb.deserialize(signed.serialize())


def _jax_node(c, root) -> dict:
    pa = c.fork_choice.proto
    i = pa.indices[root]
    parent = int(pa.parents[i])
    return dict(parent=pa.roots[parent] if parent >= 0 else None, slot=int(pa.slots[i]),
                justified_epoch=int(pa.justified_epoch[i]),
                finalized_epoch=int(pa.finalized_epoch[i]),
                unrealized_justified_epoch=int(pa.unrealized_justified_epoch[i]),
                unrealized_finalized_epoch=int(pa.unrealized_finalized_epoch[i]),
                justified_root=pa.justified_roots[i])


def _port_node(c, root) -> dict:
    node = c.fork_choice.proto.node(root)
    return {k: node[k] for k in ("parent", "slot", "justified_epoch", "finalized_epoch",
                                 "unrealized_justified_epoch", "unrealized_finalized_epoch",
                                 "justified_root")}


def _import_both(j, p, signed, source: str = "gossip", slot: int | None = None):
    """Import into both chains with the clock at ``slot`` (the block's by
    default) -> [JAX root or reason, port root or reason]."""
    slot = int(signed.message.slot) if slot is None else slot
    out = []
    for c, blk, err in ((j, signed, JaxBlockError), (p, _port(signed), BlockError)):
        c.slot_clock.set_slot(slot)
        try:
            out.append(c.process_block(blk, source=source))
        except err as e:
            out.append(e.reason)
    return out


def _unboosted_weights(fc) -> list:
    """The node weights without the applied proposer boost.  The JAX chain
    persists fork choice at finalization, and its ``to_bytes`` takes the
    boost off the live weights; the port has no persistence and keeps it
    for the rest of the slot."""
    pa = fc.proto
    w = pa.weights[:pa.n_nodes].copy()
    i = pa.indices.get(fc._applied_boost_root) if fc._applied_boost_root else None
    while i is not None and i >= 0:
        w[i] -= fc._applied_boost_amount
        i = int(pa.parents[i])
    return w.tolist()


def _assert_same_proto(fc_j, fc_p):
    """The same nodes at the same indices: roots, parents, slots, best
    children and best descendants, and the same weights but for the
    proposer boost."""
    pj, pp = fc_j.proto, fc_p.proto
    n = pj.n_nodes
    assert pp.n_nodes == n
    assert pp.roots == pj.roots
    assert pp.indices == pj.indices
    for name in ("parents", "slots", "best_child", "best_descendant"):
        assert getattr(pp, name)[:n].tolist() == getattr(pj, name)[:n].tolist(), name
    assert _unboosted_weights(fc_p) == _unboosted_weights(fc_j)


def _extend(h, n: int) -> list:
    """n blocks, each with both committees' attestations of the slot before
    (enough participation to justify and finalize)."""
    from lighthouse_tpu.state_transition import SignatureStrategy, state_transition

    blocks = []
    for _ in range(n):
        slot = int(h.state.slot)
        atts = [h.attest(slot, ci) for ci in range(2)] if slot > 0 else []
        signed = h.produce_block(attestations=atts)
        state_transition(h.state, h.spec, signed, SignatureStrategy.NO_VERIFICATION)
        blocks.append(signed)
    return blocks


def test_chain_imports_blocks_as_the_jax_chain_does():
    """34 blocks across four epoch boundaries (the checkpoints justify and
    finalize), then bad blocks: each the JAX chain's root, node and reason."""
    h = Harness(64, fork="deneb", real_crypto=False)
    j, p = _chains(h, verify=False)
    blocks = _extend(h, 34)
    for b in blocks:
        jr, pr = _import_both(j, p, b)
        assert pr == jr and isinstance(pr, bytes)
        assert _port_node(p, pr) == _jax_node(j, jr)
        assert p.state_for_block(pr).hash_tree_root(CPU) == bytes(b.message.state_root)
        assert p.head_root == j.head_root == pr
    fc_j, fc_p = j.fork_choice, p.fork_choice
    for name in ("justified", "finalized"):
        mine, theirs = getattr(fc_p, name), getattr(fc_j, name)
        assert (mine.epoch, mine.root) == (theirs.epoch, theirs.root), name
    assert fc_p.finalized.epoch > 0
    # both proto-arrays pruned at finalization to the same nodes, so node
    # indices, and the votes that hold them, agree; the balance snapshots
    # kept are the same roots (the anchor's is gone)
    _assert_same_proto(fc_j, fc_p)
    assert p.anchor_root not in fc_p.proto.indices
    assert set(fc_p._balance_snapshots) == set(fc_j._balance_snapshots)
    assert p.anchor_root not in fc_p._balance_snapshots
    node, epoch, _queued = fc_p.votes()
    assert node[:64].tolist() == fc_j._vote_next[:64].tolist()
    assert fc_p._vote_current[:64].tolist() == fc_j._vote_current[:64].tolist()
    assert epoch.tolist() == fc_j._vote_next_epoch[:64].tolist()

    # bad blocks on the same chains
    assert _import_both(j, p, blocks[-1]) == ["duplicate", "duplicate"]
    nxt = h.produce_block(attestations=[h.attest()])
    # the first three fail before the proposer's slot is marked seen; the
    # state-root fault marks it, so the good block is then a repeat on
    # gossip and imports from rpc
    cases = {
        "incorrect_proposer": lambda b: setattr(b.message, "proposer_index",
                                                (int(b.message.proposer_index) + 1) % 64),
        "unknown_parent": lambda b: setattr(b.message, "parent_root", b"\x12" * 32),
        "future_slot": lambda b: setattr(b.message, "slot", int(b.message.slot) + 5),
        "state_root_mismatch": lambda b: setattr(b.message, "state_root", b"\x11" * 32),
    }
    for want, edit in cases.items():
        bad = copy.deepcopy(nxt)
        edit(bad)
        assert _import_both(j, p, bad, slot=int(nxt.message.slot)) == [want, want]
    assert _import_both(j, p, nxt) == ["repeat_proposal", "repeat_proposal"]
    jr, pr = _import_both(j, p, nxt, source="rpc")
    assert pr == jr and _port_node(p, pr) == _jax_node(j, jr)


def test_repeat_proposal_and_blob_blocks():
    h = Harness(64, fork="deneb", real_crypto=False)
    j, p = _chains(h, verify=False)
    first = h.produce_block(attestations=[])
    other = copy.deepcopy(first)
    other.message.body.graffiti = b"\x01" * 32      # a second block of the same proposer
    jr, pr = _import_both(j, p, first)
    assert pr == jr and isinstance(pr, bytes)
    assert _import_both(j, p, other) == ["repeat_proposal", "repeat_proposal"]
    # a block with a blob commitment waits for its sidecar in both chains
    from lighthouse_tpu.state_transition import SignatureStrategy, state_transition

    state_transition(h.state, h.spec, first, SignatureStrategy.NO_VERIFICATION)
    blob_block = h.produce_block(attestations=[], blob_commitments=[b"\xc0" + b"\x00" * 47])
    assert _import_both(j, p, blob_block) == [None, None]
    root = blob_block.message.hash_tree_root()
    assert p.da_checker.missing_blob_indices(root) == j.da_checker.missing_blob_indices(root) == [0]
    assert not p.block_exists(root)


def test_real_signature_import_and_a_bad_batch():
    """Real interop signatures: the first block, then one with both
    committees' attestations, import in both chains with the same roots;
    the second's twin with the two attestation signatures swapped (signed by
    its proposer) passes the proposer's batch and fails the block batch in
    both (``source="rpc"``: a second block of the slot)."""
    h = Harness(64, fork="deneb", real_crypto=True)
    j, p = _chains(h, verify=True)
    (first,) = h.extend_chain(1)
    jr, pr = _import_both(j, p, first)
    assert pr == jr and isinstance(pr, bytes)
    slot = int(h.state.slot)
    assert jmisc.get_committee_count_per_slot(h.spec, 64) == 2
    atts = [h.attest(slot, 0), h.attest(slot, 1)]
    good = h.produce_block(attestations=atts)
    swapped = [copy.deepcopy(a) for a in atts]
    swapped[0].signature, swapped[1].signature = atts[1].signature, atts[0].signature
    bad = h.produce_block(attestations=swapped)
    jr, pr = _import_both(j, p, good)
    assert pr == jr and isinstance(pr, bytes)
    assert _port_node(p, pr) == _jax_node(j, jr)
    assert _import_both(j, p, bad, source="rpc") == ["batch_signature_invalid"] * 2


def test_heads_on_competing_branches_follow_the_jax_chain():
    """Two children of genesis (slots 1 and 2), then blocks on the first
    branch whose attestations vote for it: after each import the port's
    head (``get_head``: vote deltas, the justified balances, proposer
    boost) is the JAX chain's, and so are the nodes' weights' winners."""
    from lighthouse_tpu.state_transition import SignatureStrategy, state_transition

    h = Harness(64, fork="deneb", real_crypto=False)
    other = copy.deepcopy(h)
    j, p = _chains(h, verify=False)
    first = h.produce_block(slot=1, attestations=[])
    second = other.produce_block(slot=2, attestations=[])
    heads = []
    for b in (first, second):
        jr, pr = _import_both(j, p, b)
        assert pr == jr and isinstance(pr, bytes)
        heads.append((j.head_root, p.head_root))
    state_transition(h.state, h.spec, first, SignatureStrategy.NO_VERIFICATION)
    for slot in (3, 4):
        atts = [h.attest(int(h.state.slot), ci) for ci in range(2)]
        blk = h.produce_block(slot=slot, attestations=atts)
        state_transition(h.state, h.spec, blk, SignatureStrategy.NO_VERIFICATION)
        jr, pr = _import_both(j, p, blk)
        assert pr == jr and isinstance(pr, bytes)
        heads.append((j.head_root, p.head_root))
    assert all(jh == ph for jh, ph in heads)
    assert heads[1][0] == second.message.hash_tree_root()     # the boosted newer branch
    assert heads[-1][0] == blk.message.hash_tree_root()        # votes moved it back
    for c in (j, p):
        c.slot_clock.set_slot(8)
    assert p.recompute_head() == j.recompute_head()


def test_finalization_prunes_an_orphaned_branch_as_the_jax_chain_does():
    """A second block of slot 2 (no votes) beside the canonical
    chain: it stays in both proto-arrays until the finalized checkpoint
    moves past genesis, then both prune it (and the anchor) away, keep the
    same nodes at the same indices, and agree on the head before and
    after."""
    h = Harness(64, fork="deneb", real_crypto=False)
    other = copy.deepcopy(h)
    j, p = _chains(h, verify=False)
    orphan = other.produce_block(slot=2, attestations=[])
    blocks = _extend(h, 34)
    orphan_root = orphan.message.hash_tree_root()
    pruned_at = None
    for k, b in enumerate(blocks):
        if int(b.message.slot) == 3:
            # the slot's proposer already proposed: a repeat on gossip, so rpc
            assert _import_both(j, p, orphan, source="rpc", slot=3) == [orphan_root] * 2
        jr, pr = _import_both(j, p, b)
        assert pr == jr and isinstance(pr, bytes)
        assert p.head_root == j.head_root
        in_j, in_p = orphan_root in j.fork_choice.proto, orphan_root in p.fork_choice.proto
        assert in_j == in_p
        if int(b.message.slot) >= 3 and not in_p and pruned_at is None:
            pruned_at = k
        _assert_same_proto(j.fork_choice, p.fork_choice)
    assert pruned_at is not None and p.fork_choice.finalized.epoch > 0
    assert p.anchor_root not in p.fork_choice.proto
    assert p.fork_choice.proto.n_nodes < len(blocks) + 2
    # the pruned indices take new blocks as the JAX chain's do
    nxt = h.produce_block(attestations=[h.attest()])
    jr, pr = _import_both(j, p, nxt)
    assert pr == jr and isinstance(pr, bytes)
    _assert_same_proto(j.fork_choice, p.fork_choice)
    for c in (j, p):
        c.slot_clock.set_slot(int(nxt.message.slot) + 1)
    assert p.recompute_head() == j.recompute_head() == pr
