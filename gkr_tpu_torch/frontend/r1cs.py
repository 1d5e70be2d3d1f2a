"""circom .r1cs binary parser.

Format (iden3 r1cs binary spec, as consumed by the `r1cs-file` crate the
reference uses, rust/src/convert.rs:1):

  magic "r1cs" | version u32 | n_sections u32
  sections: type u32 | size u64 | payload
    type 1 (header): field_size u32 | prime (field_size LE bytes) |
       n_wires u32 | n_pub_out u32 | n_pub_in u32 | n_prv_in u32 |
       n_labels u64 | n_constraints u32
    type 2 (constraints): per constraint, three linear combinations A,B,C;
       each: n u32, then n x (wire_id u32, coeff field_size LE bytes)
    type 3 (wire->label map): n_wires x u64
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

MAGIC = b"r1cs"


@dataclass
class R1csHeader:
    field_size: int
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int


@dataclass
class R1csFile:
    header: R1csHeader
    # constraints[i] = (A, B, C); each a list of (coeff:int, wire:int)
    constraints: list[tuple[list, list, list]]
    wire_to_label: list[int] = field(default_factory=list)

    @classmethod
    def read(cls, path: str) -> "R1csFile":
        with open(path, "rb") as f:
            data = f.read()
        return cls.parse(data)

    @classmethod
    def parse(cls, data: bytes) -> "R1csFile":
        if data[:4] != MAGIC:
            raise ValueError("not an r1cs file")
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
        (n_wires, n_pub_out, n_pub_in, n_prv_in) = struct.unpack_from(
            "<IIII", data, h_off + 4 + fs)
        n_labels, = struct.unpack_from("<Q", data, h_off + 20 + fs)
        n_constraints, = struct.unpack_from("<I", data, h_off + 28 + fs)
        header = R1csHeader(fs, prime, n_wires, n_pub_out, n_pub_in,
                            n_prv_in, n_labels, n_constraints)

        constraints = []
        if 2 in sections:
            c_off, _ = sections[2]
            pos = c_off
            for _ in range(n_constraints):
                lcs = []
                for _ in range(3):
                    n, = struct.unpack_from("<I", data, pos)
                    pos += 4
                    lc = []
                    for _ in range(n):
                        wire, = struct.unpack_from("<I", data, pos)
                        coeff = int.from_bytes(data[pos + 4:pos + 4 + fs],
                                               "little")
                        lc.append((coeff, wire))
                        pos += 4 + fs
                    lcs.append(lc)
                constraints.append(tuple(lcs))

        wire_to_label = []
        if 3 in sections:
            m_off, m_size = sections[3]
            n = m_size // 8
            wire_to_label = list(struct.unpack_from(f"<{n}Q", data, m_off))

        return cls(header, constraints, wire_to_label)

    @staticmethod
    def write(path: str, prime: int, n_wires: int, n_pub_out: int,
              n_pub_in: int, n_prv_in: int,
              constraints: list[tuple[list, list, list]]) -> None:
        """Serialize (used by tests and the native toolchain).  The
        constraint section is joined once from its parts: appending to one
        bytes object copies it each time, quadratic in its size."""
        fs = 32
        body_header = struct.pack("<I", fs) + prime.to_bytes(fs, "little")
        body_header += struct.pack("<IIII", n_wires, n_pub_out, n_pub_in,
                                   n_prv_in)
        body_header += struct.pack("<QI", n_wires, len(constraints))

        parts = []
        for (a, b, c) in constraints:
            for lc in (a, b, c):
                parts.append(struct.pack("<I", len(lc)))
                for coeff, wire in lc:
                    parts.append(struct.pack("<I", wire))
                    parts.append(int(coeff % prime).to_bytes(fs, "little"))
        body_cons = b"".join(parts)

        out = MAGIC + struct.pack("<II", 1, 2)
        out += struct.pack("<IQ", 1, len(body_header)) + body_header
        out += struct.pack("<IQ", 2, len(body_cons)) + body_cons
        with open(path, "wb") as f:
            f.write(out)
