"""circom .wtns (witness) binary parser.

Format (iden3 wtns spec, as consumed by the `wtns-file` crate):
  magic "wtns" | version u32 | n_sections u32
  section 1 (header): field_size u32 | prime | n_witness u32
  section 2 (data): n_witness x field_size LE bytes
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"wtns"


@dataclass
class WtnsFile:
    prime: int
    values: list[int]

    @classmethod
    def read(cls, path: str) -> "WtnsFile":
        with open(path, "rb") as f:
            data = f.read()
        return cls.parse(data)

    @classmethod
    def parse(cls, data: bytes) -> "WtnsFile":
        if data[:4] != MAGIC:
            raise ValueError("not a wtns file")
        n_sections = struct.unpack_from("<I", data, 8)[0]
        off = 12
        sections = {}
        for _ in range(n_sections):
            sec_type, = struct.unpack_from("<I", data, off)
            sec_size, = struct.unpack_from("<Q", data, off + 4)
            off += 12
            sections[sec_type] = (off, sec_size)
            off += sec_size

        h_off, _ = sections[1]
        fs, = struct.unpack_from("<I", data, h_off)
        prime = int.from_bytes(data[h_off + 4:h_off + 4 + fs], "little")
        n, = struct.unpack_from("<I", data, h_off + 4 + fs)

        d_off, _ = sections[2]
        values = []
        pos = d_off
        for _ in range(n):
            values.append(int.from_bytes(data[pos:pos + fs], "little"))
            pos += fs
        return cls(prime, values)

    @staticmethod
    def write(path: str, prime: int, values: list[int]) -> None:
        fs = 32
        body_h = struct.pack("<I", fs) + prime.to_bytes(fs, "little")
        body_h += struct.pack("<I", len(values))
        body_d = b"".join(int(v % prime).to_bytes(fs, "little")
                          for v in values)
        out = MAGIC + struct.pack("<II", 2, 2)
        out += struct.pack("<IQ", 1, len(body_h)) + body_h
        out += struct.pack("<IQ", 2, len(body_d)) + body_d
        with open(path, "wb") as f:
            f.write(out)
