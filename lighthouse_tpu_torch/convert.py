"""Carry a serialized beacon state into the port."""

from __future__ import annotations

from lighthouse_tpu_torch.types import PRESETS, make_types


def state_from_ssz(data: bytes, fork: str = "deneb", preset: str = "minimal"):
    """The port's state from the SSZ bytes of a beacon state (for example
    ``state.serialize()`` of the JAX package's state), decoded by the port's
    own deserializer.  Only Deneb states are ported so far."""
    if fork != "deneb":
        raise NotImplementedError(f"fork {fork!r}: only 'deneb' states are ported")
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}: use one of {sorted(PRESETS)}")
    return make_types(PRESETS[preset]).BeaconStateDeneb.deserialize(data)
