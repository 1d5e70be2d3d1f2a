"""The yardstick's counts at small shapes, by hand."""

from benchmark.counts import sumcheck as C


def test_products_halving_tables():
    # m = 4: 14 + 18; m = 2: 7 + 9
    assert C.products(4) == 48
    assert C.products(2) == 16
    assert C.products(1 << 20) == 8 * ((1 << 21) - 2)


def test_min_bytes_small_layer():
    n, gates, k_cur = 4, 5, 1
    e, ix = 32, 4
    rounds = 4 * e * (4 + 2) + 4 * e * (2 + 1) + 3 * e * (4 + 2) + 3 * e * (2 + 1)
    build1 = 3 * ix * gates + e * n + e * 2 + 3 * e * n
    eqb = e * n
    build2 = 3 * ix * gates + e * 2 + e * n + 2 * e * n
    assert C.min_bytes(n, gates, k_cur) == rounds + build1 + eqb + build2


def test_floor_of_the_2e20_layer_is_fixed():
    n = 1 << 20
    t, bound = C.floor_s(n, n, 4)
    assert bound == "bytes"
    assert t == C.min_bytes(n, n, 4) / 3.35e12
    assert abs(t - 2.98e-4) < 1e-6
    t_ops = C.products(n) * 151.625 / (132 * 64 * 1.98e9)
    assert t_ops < t


def test_floor_takes_products_where_they_bind():
    C_ = C
    saved = C_.IMAD_PER_PRODUCT
    try:
        C_.IMAD_PER_PRODUCT = 10_000.0
        assert C_.floor_s(1 << 10, 1 << 10, 4)[1] == "products"
    finally:
        C_.IMAD_PER_PRODUCT = saved
