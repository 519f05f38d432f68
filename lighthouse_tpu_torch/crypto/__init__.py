"""Cryptography of the port: BLS12-381 (``crypto.bls``) and KZG blob
commitments (``crypto.kzg``)."""
