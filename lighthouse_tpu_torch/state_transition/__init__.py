"""State transition: per-slot processing, the Deneb epoch transition and
Deneb block processing; ``state_transition`` = slots, block, state-root
check."""

from lighthouse_tpu_torch.state_transition.block_processing import (
    BlockProcessingError,
    BulkVerifier,
    SignatureStrategy,
    process_block,
)
from lighthouse_tpu_torch.state_transition.epoch_processing import process_epoch
from lighthouse_tpu_torch.state_transition.slot_processing import (
    per_slot_processing,
    process_slot,
    state_advance,
)


def state_transition(state, spec, signed_block,
                     strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
                     validate_result: bool = True, *, device=None, bls_backend: str = "cuda",
                     shuffle_fn=None) -> None:
    """The spec's ``state_transition`` (``lighthouse_tpu/state_transition/
    __init__.py:27``): advance to the block's slot, process the block, then
    check the state root, all on ``device`` (``cuda`` unless ``"cpu"``)."""
    block = signed_block.message
    state_advance(state, spec, int(block.slot), device)
    process_block(state, spec, signed_block, strategy, device=device, bls_backend=bls_backend,
                  shuffle_fn=shuffle_fn)
    if validate_result:
        got = state.hash_tree_root(device)
        if got != bytes(block.state_root):
            raise BlockProcessingError(
                f"state root mismatch: block {bytes(block.state_root).hex()[:16]} "
                f"!= computed {got.hex()[:16]}")


__all__ = ["BlockProcessingError", "BulkVerifier", "SignatureStrategy", "per_slot_processing",
           "process_block", "process_epoch", "process_slot", "state_advance",
           "state_transition"]
