"""Fiat–Shamir transcript: Blake2b-512, byte-compatible with the reference.

Mirrors halo2_proofs/src/transcript.rs exactly:
  * personalization "Halo2-Transcript", 64-byte digest (transcript.rs:79-83)
  * prefix bytes 0/1/2 for challenge/point/scalar (transcript.rs:15-21)
  * points absorbed as affine x||y 32-byte LE canonical reprs
    (transcript.rs:128-140); scalars as 32-byte LE reprs
  * challenges squeeze a clone of the running state and reduce the 64-byte
    digest little-endian mod r (Challenge255, transcript.rs:196-201)

Proof-stream point encoding follows the halo2curves bn256 compressed form:
32-byte LE x with the parity of y in the top bit of byte 31; the identity is
all-zeros.  This is host-side Python (hashlib), sequential and cheap — it is
never device work.
"""

from __future__ import annotations

import hashlib

from halo2_tpu_torch.curves import host as g1_host
from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS

PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"

Q = FQ_MODULUS
R = FR_MODULUS


def _new_state():
    return hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")


def scalar_to_bytes(s: int) -> bytes:
    return (s % R).to_bytes(32, "little")


def scalar_from_bytes(b: bytes) -> int:
    s = int.from_bytes(b, "little")
    if s >= R:
        raise ValueError("invalid field element encoding in proof")
    return s


def point_to_bytes(p) -> bytes:
    """Compressed encoding: x LE with y-parity in bit 255; identity = zeros."""
    if p is None:
        return bytes(32)
    x, y = p
    b = bytearray(x.to_bytes(32, "little"))
    b[31] |= (y & 1) << 7
    return bytes(b)


def _sqrt_fq(a: int):
    """Square root mod q (q % 4 == 3): a^((q+1)/4); None if non-residue."""
    r = pow(a, (Q + 1) // 4, Q)
    if r * r % Q != a % Q:
        return None
    return r


def point_from_bytes(b: bytes):
    arr = bytearray(b)
    sign = (arr[31] >> 7) & 1
    arr[31] &= 0x7F
    x = int.from_bytes(bytes(arr), "little")
    if x == 0:
        if sign:
            raise ValueError("invalid point encoding in proof")
        return None  # identity
    if x >= Q:
        raise ValueError("invalid point encoding in proof")
    y2 = (x * x % Q * x + g1_host.B) % Q
    y = _sqrt_fq(y2)
    if y is None:
        raise ValueError("invalid point encoding in proof")
    if y & 1 != sign:
        y = Q - y
    return (x, y)


class _TranscriptBase:
    def __init__(self):
        self._state = _new_state()

    def common_point(self, p) -> None:
        if p is None:
            raise ValueError("cannot write points at infinity to the transcript")
        self._state.update(PREFIX_POINT)
        self._state.update(p[0].to_bytes(32, "little"))
        self._state.update(p[1].to_bytes(32, "little"))

    def common_scalar(self, s: int) -> None:
        self._state.update(PREFIX_SCALAR)
        self._state.update(scalar_to_bytes(s))

    def squeeze_challenge(self) -> int:
        """Challenge255: 64-byte digest of the running state, LE mod r."""
        self._state.update(PREFIX_CHALLENGE)
        digest = self._state.copy().digest()
        return int.from_bytes(digest, "little") % R


class Blake2bWrite(_TranscriptBase):
    """Prover-side transcript; accumulates the proof byte stream."""

    def __init__(self):
        super().__init__()
        self._proof = bytearray()

    def write_point(self, p) -> None:
        self.common_point(p)
        self._proof += point_to_bytes(p)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self._proof += scalar_to_bytes(s)

    def finalize(self) -> bytes:
        return bytes(self._proof)


class Blake2bRead(_TranscriptBase):
    """Verifier-side transcript over a proof byte stream."""

    def __init__(self, proof: bytes):
        super().__init__()
        self._buf = proof
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise ValueError("proof stream exhausted")
        out = self._buf[self._pos: self._pos + n]
        self._pos += n
        return out

    def read_point(self):
        p = point_from_bytes(self._take(32))
        self.common_point(p)
        return p

    def read_scalar(self) -> int:
        s = scalar_from_bytes(self._take(32))
        self.common_scalar(s)
        return s

    def assert_exhausted(self):
        if self._pos != len(self._buf):
            raise ValueError("trailing bytes in proof")
