"""State transition: per-slot processing and the Deneb epoch transition."""

from lighthouse_tpu_torch.state_transition.epoch_processing import process_epoch
from lighthouse_tpu_torch.state_transition.slot_processing import (
    per_slot_processing,
    process_slot,
    state_advance,
)

__all__ = ["per_slot_processing", "process_epoch", "process_slot", "state_advance"]
