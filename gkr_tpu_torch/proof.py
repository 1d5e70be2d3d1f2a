"""GKR proof data model + JSON (de)serialization.

Field-for-field mirror of the production proof struct
(`rust/src/gkr.rs:8-19`):

    sumcheck_proofs : [layer][round][coeff]  (coeffs highest-degree-first)
    sumcheck_r      : [layer][round]         (Fiat–Shamir challenges)
    d               : sparse MLE term list of the output vector D
    q               : [layer][coeff]         q_i(t) = W~_{i+1}(l(t))
    z               : [layer+1][k]           evaluation points (z_0 = 0…0)
    r               : [layer]                r*_i = MiMC(last round poly)
    depth           : circuit depth + 1      (prover.rs:92)
    input_func      : sparse MLE term list of the input layer
    k               : [k_0..k_depth]

Serialization uses decimal strings (rust/src/file_utils.rs:20-28).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from .field import P


@dataclass
class Proof:
    sumcheck_proofs: list[list[list[int]]]
    sumcheck_r: list[list[int]]
    d: list[list[int]]
    q: list[list[int]]
    z: list[list[int]]
    r: list[int]
    depth: int
    input_func: list[list[int]]
    k: list[int]

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        s = str
        return {
            "sumcheckProof": [[[s(c) for c in rnd] for rnd in layer]
                              for layer in self.sumcheck_proofs],
            "sumcheckr": [[s(c) for c in layer] for layer in self.sumcheck_r],
            "q": [[s(c) for c in layer] for layer in self.q],
            "D": [[s(c) for c in t] for t in self.d],
            "z": [[s(c) for c in layer] for layer in self.z],
            "r": [s(c) for c in self.r],
            "inputFunc": [[s(c) for c in t] for t in self.input_func],
            "depth": self.depth,
            "k": list(self.k),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Proof":
        i = lambda x: int(x) % P  # noqa: E731
        return cls(
            sumcheck_proofs=[[[i(c) for c in rnd] for rnd in layer]
                             for layer in d["sumcheckProof"]],
            sumcheck_r=[[i(c) for c in layer] for layer in d["sumcheckr"]],
            q=[[i(c) for c in layer] for layer in d["q"]],
            d=[[i(c) for c in t] for t in d["D"]],
            z=[[i(c) for c in layer] for layer in d["z"]],
            r=[i(c) for c in d["r"]],
            input_func=[[i(c) for c in t] for t in d["inputFunc"]],
            depth=int(d["depth"]),
            k=[int(x) for x in d["k"]],
        )

    def to_json(self, path: str | None = None, indent: int | None = None) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, s: str) -> "Proof":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_json_file(cls, path: str) -> "Proof":
        with open(path) as f:
            return cls.from_dict(json.load(f))
