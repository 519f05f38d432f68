"""State transition: per-slot processing (epoch processing not ported yet)."""

from lighthouse_tpu_torch.state_transition.slot_processing import (
    per_slot_processing,
    process_slot,
)

__all__ = ["per_slot_processing", "process_slot"]
