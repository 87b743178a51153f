"""halo2's Blake2b transcript, read side: Blake2b-512 with personalization
"Halo2-Transcript", prefix 0 before a challenge, 1 before a point (affine
x || y, 32 bytes each little-endian), 2 before a scalar; a challenge is the
digest of a copy of the running state, little-endian, mod r."""

from __future__ import annotations

import hashlib

from benchmark.reference import bn254


class Reader:
    def __init__(self, proof: bytes):
        self._state = hashlib.blake2b(digest_size=64,
                                      person=b"Halo2-Transcript")
        self._buf = proof
        self._pos = 0

    def common_scalar(self, s: int):
        self._state.update(b"\x02" + (s % bn254.R).to_bytes(32, "little"))

    def common_point(self, p):
        if p is None:
            raise ValueError("the identity cannot enter the transcript")
        self._state.update(b"\x01" + p[0].to_bytes(32, "little")
                           + p[1].to_bytes(32, "little"))

    def challenge(self) -> int:
        self._state.update(b"\x00")
        return int.from_bytes(self._state.copy().digest(), "little") % bn254.R

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise ValueError("proof too short")
        out = self._buf[self._pos: self._pos + n]
        self._pos += n
        return out

    def point(self):
        p = bn254.point_from_bytes(self._take(32))
        self.common_point(p)
        return p

    def scalar(self) -> int:
        s = bn254.scalar_from_bytes(self._take(32))
        self.common_scalar(s)
        return s

    def exhausted(self) -> bool:
        return self._pos == len(self._buf)
