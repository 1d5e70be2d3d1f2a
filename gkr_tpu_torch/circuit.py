"""Layered arithmetic circuit model for the GKR prover.

Mirrors the reference's data model (`rust/src/gkr.rs:35-114`: per-layer k,
add/mult wiring, plus the raw wire bit-vectors used by the sparse sumcheck)
but keeps a dense, device-friendly canonical form: wiring as integer gate
triples (out, left, right) — the COO/gate-list form, equivalent to the
reference's `wire` bit-string vectors (rust/src/convert.rs:715-775) — and
layer values as dense tables.

Layer i connects W_i (size 2^k(i)) to W_{i+1} (size 2^k(i+1)); layer 0 is the
output layer; layer `depth` is the input layer (k(depth) = input_k), exactly
like `GKRCircuit::k` (rust/src/gkr.rs:83-88).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import P


@dataclass
class GateLayer:
    k_cur: int                      # log2 size of this layer's output table W_i
    k_next: int                     # log2 size of W_{i+1}
    add_gates: list[tuple[int, int, int]] = dc_field(default_factory=list)
    mult_gates: list[tuple[int, int, int]] = dc_field(default_factory=list)

    def n_gates(self) -> int:
        return len(self.add_gates) + len(self.mult_gates)


@dataclass
class GKRCircuit:
    layers: list[GateLayer]
    input_k: int

    def depth(self) -> int:
        return len(self.layers)

    def k(self, i: int) -> int:
        if i == len(self.layers):
            return self.input_k
        return self.layers[i].k_cur

    def k_list(self) -> list[int]:
        return [self.k(i) for i in range(self.depth() + 1)]

    def validate(self) -> None:
        for i, layer in enumerate(self.layers):
            assert layer.k_cur == self.k(i)
            k_next = self.k(i + 1)
            assert layer.k_next == k_next
            assert layer.k_next >= 1, "layers below the output must have >= 2 gates"
            for (o, l, r) in layer.add_gates + layer.mult_gates:
                assert 0 <= o < (1 << layer.k_cur)
                assert 0 <= l < (1 << k_next)
                assert 0 <= r < (1 << k_next)

    def evaluate(self, input_values: list[int]) -> list[list[int]]:
        """Forward sweep: returns [W_0, ..., W_depth] dense value tables.

        Matches `calculate_input`'s witness sweep (rust/src/convert.rs:787-849):
        gate outputs get left+right / left*right; indices with no gate are 0.
        """
        assert len(input_values) == 1 << self.input_k
        w = [None] * (self.depth() + 1)
        w[self.depth()] = [v % P for v in input_values]
        for i in range(self.depth() - 1, -1, -1):
            layer = self.layers[i]
            nxt = w[i + 1]
            vals = [0] * (1 << layer.k_cur)
            for (o, l, r) in layer.add_gates:
                vals[o] = (vals[o] + nxt[l] + nxt[r]) % P
            for (o, l, r) in layer.mult_gates:
                vals[o] = (vals[o] + nxt[l] * nxt[r]) % P
            w[i] = vals
        return w

    def add_mult_eval(self, i: int, point: list[int]) -> tuple[int, int]:
        """Evaluate the wiring-predicate MLEs add~_i and mult~_i at a point of
        length k(i) + 2*k(i+1).  Each gate contributes the eq-product of its
        "out||left||right" label bits (the dense semantics of
        `chi_w_for_binary` + `partial_eval_binary_form`,
        rust/src/gkr/poly.rs:28-62).

        NOTE on duplicate gates: a duplicated (out,l,r) row contributes twice,
        exactly as `add_poly`-merged chi_w terms would (coefficient 2).
        """
        from .mle import eq_bits

        layer = self.layers[i]
        kc, kn = layer.k_cur, layer.k_next
        zc = point[:kc]
        bb = point[kc:kc + kn]
        cc = point[kc + kn:]
        n_gates = len(layer.add_gates) + len(layer.mult_gates)

        def lookup(coords):
            # shared per-coordinate eq-product evaluator: full table by
            # doubling (2*2^k muls) when the gate list is dense, else a
            # lazy memo (k muls per DISTINCT label) — exact either way,
            # ~k x cheaper than per-gate products on wide layers.
            k = len(coords)
            if n_gates * max(k - 1, 1) > (1 << (k + 1)):
                tbl = [1]
                for x in coords:
                    xc = (1 - x) % P
                    tbl = [t * f % P for t in tbl for f in (xc, x)]
                return tbl.__getitem__
            memo: dict[int, int] = {}

            def get(label: int) -> int:
                v = memo.get(label)
                if v is None:
                    v = eq_bits(coords, label)
                    memo[label] = v
                return v
            return get

        eq_z, eq_b, eq_c = lookup(zc), lookup(bb), lookup(cc)

        def acc(gates):
            total = 0
            for (o, l, r) in gates:
                total = (total + eq_z(o) * eq_b(l) % P * eq_c(r)) % P
            return total

        return acc(layer.add_gates), acc(layer.mult_gates)


def get_k(n: int) -> int:
    """ceil(log2(n)) with get_k(1) = 0 (rust/src/convert.rs:140-152)."""
    if n <= 1:
        return 0
    k = (n - 1).bit_length()
    return k


def synth_circuit(k: int, k_input: int, seed: int = 7):
    """Depth-3 synthetic circuit with 2^k-gate wide layers and its inputs:
    16 outputs <- 2^k gates <- 2^k-entry layer <- 2^k gates <- 2^k_input
    inputs, half add and half mult gates in the wide layers.  The
    full-prove configuration of the JAX package's bench (`synth_circuit`
    there), with wiring and inputs drawn from numpy `default_rng(seed)`.

    Returns (circuit, inputs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, ni = 1 << k, 1 << k_input

    def gates(out, fan_in):
        lr = rng.integers(0, fan_in, size=(len(out), 2))
        return list(zip(out.tolist(), lr[:, 0].tolist(), lr[:, 1].tolist()))

    l0 = GateLayer(4, k, add_gates=gates(np.arange(16), n))
    mid = gates(np.arange(n), n)
    l1 = GateLayer(k, k, add_gates=mid[1::2], mult_gates=mid[0::2])
    low = gates(np.arange(n), ni)
    l2 = GateLayer(k, k_input, add_gates=low[1::2], mult_gates=low[0::2])
    raw = rng.bytes(32 * ni)
    inputs = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P
              for i in range(ni)]
    return GKRCircuit(layers=[l0, l1, l2], input_k=k_input), inputs
