"""Attestation pools of the gossip path: naive aggregation and the pre-BLS
coalescing stage."""
