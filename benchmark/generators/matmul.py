"""The matrix-product circuit of the GKR literature (Thaler, CRYPTO 2013;
Libra, CRYPTO 2019): C = A B for n x n matrices over the field.

Inputs: A row-major, then B row-major (2 n^2 entries).  The bottom layer
has one mult gate per (i, j, k), gate (i n + j) n + k computing
A[i, k] * B[k, j]; then log2(n) add layers, each summing adjacent pairs,
leave C[i, j] at output i n + j.  n must be a power of two.

Config keys: "n".
"""

from __future__ import annotations

import numpy as np

from .common import elements, evaluate


def circuit(cfg: dict, g: np.random.Generator | None = None) -> dict:
    n = cfg["n"]
    t = n.bit_length() - 1
    if 1 << t != n:
        raise ValueError(f"n = {n} is not a power of two")
    i, j, k = np.meshgrid(*(np.arange(n, dtype=np.int64),) * 3, indexing="ij")
    gid = ((i * n + j) * n + k).ravel()
    mult = np.stack([gid, (i * n + k).ravel(), (n * n + k * n + j).ravel()])
    layers = [(3 * t, 2 * t + 1, None, mult)]          # above the inputs
    for s in range(1, t + 1):                            # the add tree
        kc = 3 * t - s
        o = np.arange(1 << kc, dtype=np.int64)
        layers.append((kc, kc + 1, np.stack([o, 2 * o, 2 * o + 1]), None))
    return {"layers": layers[::-1], "input_k": 2 * t + 1}


def witness(circ: dict, g: np.random.Generator) -> list[list[int]]:
    """The tables for uniform random A and B."""
    n2 = 1 << (circ["input_k"] - 1)
    return evaluate(circ["layers"], elements(g, 2 * n2))


def product(inputs: list[int], n: int) -> list[int]:
    """C = A B, row-major, from the input table: the circuit's plain
    reference."""
    p = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    a = np.array(inputs[:n * n], dtype=object).reshape(n, n)
    b = np.array(inputs[n * n:], dtype=object).reshape(n, n)
    return [int(x) % p for x in a.dot(b).ravel()]
