"""BLS12-381 for eth2 in the port: host oracles (copies of the JAX
package's) and the backend registry; ``verify_signature_sets(sets,
backend="cuda")`` runs the batch on the card (``ops/bls_backend.py``)."""

from lighthouse_tpu_torch.crypto.bls.api import (
    BlsError,
    PublicKey,
    SecretKey,
    Signature,
    SignatureSet,
    aggregate_verify,
    backend_health,
    fast_aggregate_verify,
    get_backend,
    recoveries,
    register_backend,
    reset_supervisor,
    set_backend,
    verify,
    verify_signature_sets,
)
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import DST_G2, hash_to_g2

__all__ = [
    "BlsError", "PublicKey", "SecretKey", "Signature", "SignatureSet", "aggregate_verify",
    "backend_health", "fast_aggregate_verify", "get_backend", "recoveries", "register_backend",
    "reset_supervisor", "set_backend", "verify", "verify_signature_sets", "DST_G2", "hash_to_g2",
]
