"""The project's headline synthetic layer and circuit (`synth_layer` and
`synth_circuit` of the project's `bench.py`), drawn with numpy from the
seed.  The same shapes and distributions: gate g is an add gate when g is
odd and a mult gate when it is even, its inputs uniform over the next
layer; the values uniform over the field.

Config keys: "k" (log2 of the wide layers' gates and entries), "k_input"
(log2 of the inputs), "k_out" (log2 of the outputs, 16 in the source).
"""

from __future__ import annotations

import numpy as np

from .common import elements, evaluate


def _wide(g: np.random.Generator, n_gates: int, k_out_mask: int,
          fan_in: int):
    """Half add (odd g), half mult (even g) gates; gate g writes output
    g & k_out_mask and reads two uniform inputs below fan_in."""
    gid = np.arange(n_gates, dtype=np.int64)
    lr = g.integers(0, fan_in, size=(2, n_gates), dtype=np.int64)
    cols = np.stack([gid & k_out_mask, lr[0], lr[1]])
    return cols[:, 1::2].copy(), cols[:, 0::2].copy()


def layer(cfg: dict, g: np.random.Generator) -> dict:
    """`synth_layer(k)`: 2^k gates over 2^k_cur outputs, 2^k random
    next-layer values."""
    k, k_cur = cfg["layer"]["k"], cfg["layer"]["k_cur"]
    n = 1 << k
    add, mult = _wide(g, n, (1 << k_cur) - 1, n)
    return {"k_cur": k_cur, "k_next": k, "add": add, "mult": mult,
            "w": elements(g, n)}


def circuit(cfg: dict, g: np.random.Generator) -> dict:
    """`synth_circuit(k, k_input)`: 2^k_out outputs <- 2^k gates <- 2^k
    gates <- 2^k_input inputs."""
    k, ki, ko = cfg["k"], cfg["k_input"], cfg["k_out"]
    n = 1 << k
    top = g.integers(0, n, size=(2, 1 << ko), dtype=np.int64)
    l0 = (ko, k, np.stack([np.arange(1 << ko, dtype=np.int64), top[0], top[1]]), None)
    l1 = (k, k, *_wide(g, n, n - 1, n))
    l2 = (k, ki, *_wide(g, n, n - 1, 1 << ki))
    return {"layers": [l0, l1, l2], "input_k": ki}


def witness(circ: dict, g: np.random.Generator) -> list[list[int]]:
    """The tables W_0 .. W_depth for uniform random inputs."""
    return evaluate(circ["layers"], elements(g, 1 << circ["input_k"]))
