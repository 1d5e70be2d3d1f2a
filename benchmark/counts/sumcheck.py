"""The least time one fused layer sumcheck could take on the card, from the
algorithm's shapes: the yardstick of `sumcheck_roofline`.

The floor is the larger of two bounds:

  * bytes: each stage reads its inputs once and writes its outputs once,
    at 32 bytes a field element and 4 bytes a gate index.  Stages: the
    phase-1 build (gates, W and eq(z) in; HA1, HA2, HM out), every
    phase-1 round (its 4 tables in, their halves out), the eq(b*) table,
    the phase-2 build (gates, eq(z), eq(b*) in; FA, FM out), every
    phase-2 round (3 tables in, halves out);
  * products: the round evaluations' and folds' Montgomery products (3.5 m
    in phase 1 and 4.5 m in phase 2 for tables of m entries, halving from
    n: the project's `work` count), each priced at 151.625 IMAD issue
    slots, the least count of any integer product the port has compiled
    (its `fr_mul`'s SASS on the H100).

Peaks are fixed, never read at run time: 3.35 TB/s of device memory and
132 SMs x 64 IMAD a clock x 1.98 GHz, the H100 SXM's data sheet.  The
serial Fiat-Shamir chain (2k MiMC7-91 hashes) is no part of the floor: a
floor has to hold for any implementation of the hash.
"""

from __future__ import annotations

ELEMENT_BYTES = 32
INDEX_BYTES = 4
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
IMAD_PER_PRODUCT = 151.625


def products(n: int) -> int:
    """Montgomery products of the round evaluations and folds of a layer
    with n-entry tables."""
    total = 0
    m = n
    while m >= 2:
        total += int(3.5 * m) + int(4.5 * m)
        m //= 2
    return total


def min_bytes(n: int, gates: int, k_cur: int) -> int:
    """Device-memory bytes of a layer with n-entry tables, `gates` gates
    and 2^k_cur outputs, each stage's input read once, its output written
    once."""
    e, ix = ELEMENT_BYTES, INDEX_BYTES
    eqz = e << k_cur
    rounds = 0
    for tables in (4, 3):
        m = n
        while m >= 2:
            rounds += tables * e * m + tables * e * (m // 2)
            m //= 2
    build1 = 3 * ix * gates + e * n + eqz + 3 * e * n
    eqb = e * n
    build2 = 3 * ix * gates + eqz + e * n + 2 * e * n
    return rounds + build1 + eqb + build2


def floor_s(n: int, gates: int, k_cur: int) -> tuple[float, str]:
    """(seconds, the bound that sets them: "bytes" or "products")."""
    t_bytes = min_bytes(n, gates, k_cur) / HBM_BYTES_PER_S
    t_ops = products(n) * IMAD_PER_PRODUCT / IMAD_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "products")
