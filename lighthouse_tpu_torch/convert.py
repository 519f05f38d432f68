"""Carry serialized inputs into the port: beacon states, BLS signature sets
and KZG trusted setups."""

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


def signature_sets_from_bytes(items):
    """The port's signature sets from serialized ones: each item is
    ``(pubkeys, signature, message)`` with ``pubkeys`` a sequence of 48-byte
    compressed G1 keys and ``signature`` 96 compressed G2 bytes, as the JAX
    package's ``PublicKey.to_bytes`` and ``Signature.to_bytes`` give them."""
    from lighthouse_tpu_torch.crypto.bls import api

    return [api.SignatureSet(api.Signature(bytes(sig)), [api.PublicKey(bytes(pk)) for pk in pks],
                             bytes(msg))
            for pks, sig, msg in items]


def kzg_settings_from_points(settings):
    """The port's ``KzgSettings`` from another package's setup object (for
    example the JAX package's ``KzgSettings``): its affine G1 int pairs and
    its G2 points, whose Fq2 coordinates carry ``.a`` and ``.b`` ints, the
    monomial halves included when it has them."""
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2
    from lighthouse_tpu_torch.crypto.kzg import KzgSettings

    def g1(p):
        return None if p is None else (int(p[0]), int(p[1]))

    def g2(q):
        return None if q is None else (Fq2(int(q[0].a), int(q[0].b)), Fq2(int(q[1].a), int(q[1].b)))

    g1_mono = getattr(settings, "g1_monomial", None)
    g2_mono = getattr(settings, "g2_monomial", None)
    return KzgSettings(int(settings.width), [g1(p) for p in settings.g1_lagrange_brp],
                       g2(settings.g2_tau), [int(w) for w in settings.roots_brp],
                       g1_monomial=None if g1_mono is None else [g1(p) for p in g1_mono],
                       g2_monomial=None if g2_mono is None else [g2(q) for q in g2_mono])
