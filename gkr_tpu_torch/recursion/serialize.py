"""Proof -> circom-input serialization: meta extraction and fixed-shape
padding.

Mirrors rust/src/aggregator.rs:

  get_meta (aggregator.rs:92-141): per proof —
    meta[0] depth, meta[1] largest k, meta[2] k_0, meta[3] #D terms,
    meta[4] max round-poly length, meta[5] max q length,
    meta[6] #input-MLE terms, meta[7] k_input, meta[8..] all k_i.

  modify_proof_for_circom (aggregator.rs:143-213): pad round polys and q
    with LEADING zeros (high-degree coefficients, preserving the
    highest-degree-first order), pad sumcheck_r/z with TRAILING zeros, pad
    each layer's round list to 2*largest_k rows.

  CircomInputProof (aggregator.rs:20-82): decimal-string JSON with keys
    sumcheckProof / sumcheckr / q / D / z / r / inputFunc; per-instance
    key suffixes 0,1,... are added by write_aggregated_input
    (file_utils.rs:49-67).
"""

from __future__ import annotations

import json

from ..field import P
from ..proof import Proof


def get_meta(proofs: list[Proof]) -> list[list[int]]:
    metas = []
    for proof in proofs:
        meta = [proof.depth]
        meta.append(max(proof.k))
        meta.append(proof.k[0])
        meta.append(len(proof.d))
        meta.append(max(max(len(rnd) for rnd in layer)
                        for layer in proof.sumcheck_proofs))
        meta.append(max(len(qq) for qq in proof.q))
        meta.append(len(proof.input_func))
        meta.append(proof.k[proof.depth - 1])
        meta.extend(proof.k)
        metas.append(meta)
    return metas


def modify_proof_for_circom(proofs: list[Proof],
                            metas: list[list[int]]) -> list[Proof]:
    out = []
    for pr, meta in zip(proofs, metas):
        largest_k, max_terms, max_q = meta[1], meta[4], meta[5]

        sumcheck_proofs = []
        for layer in pr.sumcheck_proofs:
            rows = [[0] * (max_terms - len(rnd)) + list(rnd)
                    for rnd in layer]
            while len(rows) < 2 * largest_k:
                rows.append([0] * max_terms)
            sumcheck_proofs.append(rows)

        sumcheck_r = [list(layer) + [0] * (2 * largest_k - len(layer))
                      for layer in pr.sumcheck_r]
        q = [[0] * (max_q - len(qq)) + list(qq) for qq in pr.q]
        z = [list(zz) + [0] * (largest_k - len(zz)) for zz in pr.z]

        out.append(Proof(
            sumcheck_proofs=sumcheck_proofs,
            sumcheck_r=sumcheck_r,
            d=pr.d, q=q, z=z, r=pr.r, depth=pr.depth,
            input_func=pr.input_func, k=pr.k))
    return out


class CircomInputProof:
    """Decimal-string view of a (padded) proof, circom signal layout."""

    def __init__(self, proof: Proof):
        s = str
        self.fields = {
            "sumcheckProof": [[[s(c % P) for c in rnd] for rnd in layer]
                              for layer in proof.sumcheck_proofs],
            "sumcheckr": [[s(c % P) for c in layer]
                          for layer in proof.sumcheck_r],
            "q": [[s(c % P) for c in qq] for qq in proof.q],
            "D": [[s(c % P) for c in t] for t in proof.d],
            "z": [[s(c % P) for c in zz] for zz in proof.z],
            "r": [s(c % P) for c in proof.r],
            "inputFunc": [[s(c % P) for c in t] for t in proof.input_func],
        }


def write_aggregated_input(input_path: str, proofs: list[CircomInputProof],
                           out_path: str = "aggregated.json") -> str:
    """Merge per-instance proof fields (key suffix = instance index) into the
    user's input JSON (file_utils.rs:49-67)."""
    with open(input_path) as f:
        input_json = json.load(f)
    for i, cip in enumerate(proofs):
        for k, v in cip.fields.items():
            input_json[f"{k}{i}"] = v
    with open(out_path, "w") as f:
        json.dump(input_json, f, indent=2, sort_keys=True)
    return out_path
