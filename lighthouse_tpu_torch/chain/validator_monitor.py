"""Per-validator gossip accounting for registered validators.

Port of the registration and ``on_gossip_attestation`` (:127-133) of
``lighthouse_tpu/chain/validator_monitor.py``: unaggregated attestations
seen on gossip count per (epoch, validator) for monitored validators.
"""

from __future__ import annotations

import numpy as np


class ValidatorMonitor:
    def __init__(self, auto_register: bool = False):
        self.auto_register = auto_register
        self.registered: set[int] = set()
        self.attestations_seen: dict[int, dict[int, int]] = {}   # epoch -> validator -> n

    def register(self, validator_index: int) -> None:
        self.registered.add(int(validator_index))

    def _monitored(self, v: int) -> bool:
        return self.auto_register or v in self.registered

    def on_gossip_attestation(self, indices, data, spec) -> None:
        epoch = int(data.target.epoch)
        for v in np.asarray(indices).reshape(-1).tolist():
            if self._monitored(v):
                per = self.attestations_seen.setdefault(epoch, {})
                per[v] = per.get(v, 0) + 1
