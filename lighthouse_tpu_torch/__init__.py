"""PyTorch and CUDA port of ``lighthouse_tpu`` for NVIDIA Hopper (H100).

Modules keep the names of their counterparts in the JAX package.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version instead.

Ported so far: the SHA-256 merkleization path of the per-slot state root
(``ops.sha256``, ``ssz``, ``types``, ``ssz.tree_cache``,
``state_transition.slot_processing``) for Deneb states, and BLS12-381 batch
signature verification (``crypto.bls.verify_signature_sets(sets,
backend="cuda")`` over ``ops.bls_backend``, ``ops.msm``, ``ops.ec``,
``ops.bls12_381``, ``ops.bigint`` and ``ops.dispatch_pipeline``), the
Deneb epoch boundary (``state_transition.epoch_processing``), Deneb blob
KZG verification (``crypto.kzg`` over ``ops.fr``, ``ops.msm`` and
``ops.bls12_381``) with the trusted-setup load, and the gossip attestation
firehose (``chain.columnar_ingest.process_wire_batch`` over
``chain.beacon_chain``, ``chain.pubkey_plane`` and ``ops.pubkey_kernels``).
"""

__version__ = "0.1.0"
