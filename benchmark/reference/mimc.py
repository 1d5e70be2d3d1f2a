"""MiMC7 over BN254 Fr with Python ints: the reference's Fiat-Shamir hash.

The iden3 / circomlib construction the protocol states (constants from a
Keccak-256 chain seeded with b"mimc", cts[0] = 0; hash(x, k) = 91 rounds
of t^7; multi_hash in Miyaguchi-Preneel form with key 0), written here
from that description with its own Keccak-256 (legacy 0x01 padding).
`Mimc7(rounds)` with another round count is the control's hash.
"""

from __future__ import annotations

from functools import lru_cache

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ROUNDS = 91

_MASK64 = (1 << 64) - 1
_RHO = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]          # _RHO[x][y]


def _round_constants() -> list[int]:
    out, r = [], 1
    for _ in range(24):
        c = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) % 256
            if r & 2:
                c |= 1 << ((1 << j) - 1)
        out.append(c)
    return out


_RC = _round_constants()


def _rol(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK64 if n else v


def _permute(a: list[list[int]]) -> None:
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _RHO[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc


def keccak256(data: bytes) -> bytes:
    rate = 136
    msg = bytearray(data) + b"\x01"
    msg += b"\x00" * (-len(msg) % rate)
    msg[-1] |= 0x80
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            a[i % 5][i // 5] ^= int.from_bytes(msg[off + 8 * i:off + 8 * i + 8],
                                                "little")
        _permute(a)
    return b"".join(a[i % 5][i // 5].to_bytes(8, "little") for i in range(4))


@lru_cache(maxsize=None)
def constants(rounds: int = ROUNDS) -> tuple[int, ...]:
    cts = [0]
    c = int.from_bytes(keccak256(b"mimc"), "big")
    for _ in range(1, rounds):
        c = int.from_bytes(keccak256(c.to_bytes((c.bit_length() + 7) // 8, "big")),
                           "big")
        cts.append(c % P)
    return tuple(cts)


class Mimc7:
    def __init__(self, rounds: int = ROUNDS):
        self.cts = constants(rounds)

    def hash(self, x: int, k: int) -> int:
        t = (x + k) % P
        h = pow(t, 7, P)
        for c in self.cts[1:]:
            h = pow((h + k + c) % P, 7, P)
        return (h + k) % P

    def multi_hash(self, arr, key: int = 0) -> int:
        r = key % P
        for x in arr:
            x %= P
            r = (r + x + self.hash(x, r)) % P
        return r
