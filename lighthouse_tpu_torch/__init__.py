"""PyTorch and CUDA port of ``lighthouse_tpu`` for NVIDIA Hopper (H100).

Modules keep the names of their counterparts in the JAX package.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version instead.

Ported so far: the SHA-256 merkleization path of the per-slot state root
(``ops.sha256``, ``ssz``, ``types``, ``ssz.tree_cache``,
``state_transition.slot_processing``) for Deneb states.
"""

__version__ = "0.1.0"
