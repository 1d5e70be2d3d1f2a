"""What every generator shares: field elements from a seeded stream, gate
columns as the program takes them, and the plain forward sweep that gives
a circuit's tables."""

from __future__ import annotations

from operator import itemgetter

import numpy as np

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy stream for (seed, *stream); seeds of any size."""
    return np.random.default_rng([int(seed), *stream])


def elements(g: np.random.Generator, n: int) -> list[int]:
    """n field elements, each from 32 random bytes reduced mod p."""
    raw = g.bytes(32 * n)
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P for i in range(n)]


def gate_tuples(cols: np.ndarray | None) -> list[tuple[int, int, int]]:
    """(3, G) columns [out, left, right] -> the (out, left, right) list."""
    if cols is None:
        return []
    o, left, right = cols.tolist()
    return list(zip(o, left, right))


def evaluate_layer(k_cur: int, nxt: list[int], add, mult) -> list[int]:
    """W_i from W_{i+1}: each output sums left + right over its add gates
    and left * right over its mult gates; outputs without a gate are 0."""
    vals = [0] * (1 << k_cur)
    for cols, mult_op in ((add, False), (mult, True)):
        if cols is None or cols.shape[1] == 0:
            continue
        o, left, right = cols.tolist()
        a = itemgetter(*left)(nxt) if len(left) > 1 else (nxt[left[0]],)
        b = itemgetter(*right)(nxt) if len(right) > 1 else (nxt[right[0]],)
        if mult_op:
            res = [x * y % P for x, y in zip(a, b)]
        else:
            res = [(x + y) % P for x, y in zip(a, b)]
        for oi, v in zip(o, res):
            vals[oi] = (vals[oi] + v) % P
    return vals


def evaluate(layers, inputs: list[int]) -> list[list[int]]:
    """[W_0, ..., W_depth] of a circuit given as (k_cur, k_next, add, mult)
    layers, output layer first, from its input table."""
    w = [list(inputs)]
    for k_cur, _k_next, add, mult in reversed(layers):
        w.append(evaluate_layer(k_cur, w[-1], add, mult))
    return w[::-1]
