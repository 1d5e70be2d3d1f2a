"""Pure-Python Keccak-256 (legacy/Ethereum padding, NOT NIST SHA3).

Needed to derive the MiMC7 round constants exactly as circomlib / mimc-rs /
go-iden3-crypto do (the reference's transcript hash: rust/src/gkr/sumcheck.rs:45
`Mimc7::new(91)`).  `hashlib.sha3_256` uses the NIST 0x06 domain padding and
yields different digests, so we implement the original Keccak with 0x01 padding.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f1600(lanes):
    # lanes: 5x5 list of 64-bit ints, lanes[x][y]
    rc = 1
    for _round in range(24):
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [[lanes[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        x, y = 1, 0
        current = lanes[x][y]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            current, lanes[x][y] = lanes[x][y], _rol(current, (t + 1) * (t + 2) // 2)
        # chi
        for yy in range(5):
            t = [lanes[xx][yy] for xx in range(5)]
            for xx in range(5):
                lanes[xx][yy] = t[xx] ^ ((~t[(xx + 1) % 5]) & t[(xx + 2) % 5]) & _MASK
        # iota
        for j in range(7):
            rc = ((rc << 1) ^ ((rc >> 7) * 0x71)) % 256
            if rc & 2:
                lanes[0][0] ^= 1 << ((1 << j) - 1)
    return lanes


def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    # pad: delimiter 0x01 (legacy Keccak), final bit 0x80
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    lanes = [[0] * 5 for _ in range(5)]
    for block_off in range(0, len(padded), rate):
        block = padded[block_off:block_off + rate]
        for i in range(rate // 8):
            x, y = i % 5, i // 5
            lanes[x][y] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = _keccak_f1600(lanes)

    out = bytearray()
    for i in range(4):  # 32 bytes
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


def keccak256_int(data: bytes) -> int:
    """Digest interpreted as a big-endian integer (the go-iden3/mimc-rs
    constant-chain convention)."""
    return int.from_bytes(keccak256(data), "big")
