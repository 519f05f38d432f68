"""The beacon chain's gossip attestation surface on the card."""
