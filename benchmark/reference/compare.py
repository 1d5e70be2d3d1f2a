"""Element-by-element comparison of the program's answers with the
reference's.  Every field element of an answer counts once; an element
the program gives and the reference does not (or the other way round)
counts as a mismatch."""

from __future__ import annotations

from .gkr import evaluate

LIMITS = {"mismatched_elements": 0, "unanswered": 0}


def _flat(x) -> list[int]:
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [int(x)]


def count(got, want) -> tuple[int, int]:
    """(elements compared, elements that differ) of two nested lists."""
    a, b = _flat(got), _flat(want)
    diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    return max(len(a), len(b)), diff


def layer_mismatches(answer, want: dict) -> tuple[int, int]:
    """A layer claim: its round polynomials, its challenges, and the final
    value the last round claims (g_v(r_v)) against the reference's
    f(b*, c*)."""
    proof, chal = answer
    c1, m1 = count(proof, want["proof"])
    c2, m2 = count(chal, want["r"])
    final = evaluate(proof[-1], chal[-1]) if proof and chal else None
    return c1 + c2 + 1, m1 + m2 + (final != want["final"])


def sparse_pairs(rows) -> list[tuple[int, int]]:
    """The program's sparse rows [coefficient, bit_1 .. bit_k] (bit 1 most
    significant) -> (monomial index, coefficient), ascending."""
    out = []
    for row in rows:
        idx = 0
        for bit in row[1:]:
            idx = 2 * idx + int(bit)
        out.append((idx, int(row[0])))
    return sorted(out)


def as_proof(ref: dict):
    """A reference proof in the program's form (attributes, sparse rows
    [coefficient, bit_1 .. bit_k]): a control's answer."""
    from types import SimpleNamespace

    def rows(pairs, k):
        return [[c] + [(i >> (k - 1 - j)) & 1 for j in range(k)] for i, c in pairs]

    return SimpleNamespace(**{**ref, "d": rows(ref["d"], ref["k"][0]),
                              "input_func": rows(ref["input_func"], ref["k"][-1])})


def proof_mismatches(proof, want: dict) -> tuple[int, int]:
    """A whole proof: every layer's round polynomials and challenges, q, the
    z chain, r*, depth, k, and the sparse forms of the output and input
    tables."""
    compared = mismatched = 0
    for field in ("sumcheck_proofs", "sumcheck_r", "q", "z", "r", "depth", "k"):
        c, m = count(getattr(proof, field), want[field])
        compared += c
        mismatched += m
    for field in ("d", "input_func"):
        c, m = count(sparse_pairs(getattr(proof, field)), want[field])
        compared += c
        mismatched += m
    return compared, mismatched
