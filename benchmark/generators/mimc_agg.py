"""Round 1 of the recursive aggregator's own example (jeong0982/gkr,
examples/mimc: the user circuit `out <== MiMC7(91)(in1, 0)`), built by the
program's native aggregation at full strength, the CLI's default.

A witness is two field elements (a, b) from the seed's stream:

  * round 0 proves the user circuit on in1 = a with the exact host engine
    (`prove_round_native(..., backend=HostBackend(), check_verify=False)`:
    its layers are at most 2^10, where the card's backend also proves on
    the host);
  * round 1 is `build_round_native` of the user circuit on in1 = b with
    one verifier gadget of round 0's proof (in-circuit Fiat-Shamir and the
    wiring recombination, the defaults), compiled at width limit 1.

The circuit is compiled once (`circuit`), from a draw (a, b) of its own: the
stages of `compile_round_native` (`builder_to_r1cs`, the frontend's
constraint trees, `compile_nodes` and its layer assembly) without its
forward sweep, so that what each input entry holds, a wire or a constant,
is kept for the witnesses.  Each witness (`witness`) builds its own round
1 and fills those inputs from its wires; its tables are swept with
`common.evaluate`, and its output table, the constraints' residuals, must
be zero everywhere, which also checks the input map.  The compiled circuit
must match the configuration's pins, or the run stops.

Config keys: "example" (the user circuit: `gkr_tpu_torch.examples`'
`<example>_example`), and the pins "constraints", "depth", "gates", "k"
(log2 of each table's entries, output first) and "wiring_sha256"
(`wiring_sha256` of the layers).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .common import elements, evaluate

PINS = ("constraints", "depth", "gates", "k", "wiring_sha256")


def _round1(example: str, g: np.random.Generator):
    """Round 0 on in1 = a, then round 1's constraint system on in1 = b."""
    from gkr_tpu_torch import HostBackend, examples
    from gkr_tpu_torch.recursion.native import build_round_native, prove_round_native

    user = getattr(examples, f"{example}_example")
    a, b = elements(g, 2)
    pairs, _ = prove_round_native(user, {"in1": a}, None, backend=HostBackend(),
                                  check_verify=False)
    return build_round_native(user, {"in1": b}, pairs)


def _cols(gates) -> np.ndarray:
    """(out, left, right) tuples -> (3, G) int64 columns."""
    return np.array(gates, dtype=np.int64).reshape(-1, 3).T.copy()


def wiring_sha256(layers) -> str:
    """SHA-256 of every layer's k_cur, k_next, gate counts and gate columns
    (little-endian int64), output layer first."""
    h = hashlib.sha256()
    for k_cur, k_next, add, mult in layers:
        h.update(np.array([k_cur, k_next, add.shape[1], mult.shape[1]], "<i8").tobytes())
        h.update(np.ascontiguousarray(add, "<i8").tobytes())
        h.update(np.ascontiguousarray(mult, "<i8").tobytes())
    return h.hexdigest()


def check_pins(cfg: dict, circ: dict) -> None:
    """Raise unless the compiled circuit is the one the configuration pins."""
    layers = circ["layers"]
    got = {"constraints": circ["constraints"], "depth": len(layers),
           "gates": int(sum(a.shape[1] + m.shape[1] for _, _, a, m in layers)),
           "k": [kc for kc, _, _, _ in layers] + [circ["input_k"]],
           "wiring_sha256": wiring_sha256(layers)}
    wrong = {key: (got[key], cfg[key]) for key in PINS if got[key] != cfg[key]}
    if wrong:
        raise ValueError(f"the compiled round 1 differs from the configuration's "
                         f"pins (got, pinned): {wrong}")


def circuit(cfg: dict, g: np.random.Generator) -> dict:
    """The compiled round-1 circuit: (k_cur, k_next, add, mult) layers,
    output first, with (3, G) columns; its input map and constraint count."""
    from gkr_tpu_torch.frontend.compiler import (_ir_to_circuit, compile_nodes,
                                                 convert_constraints_to_nodes)
    from gkr_tpu_torch.recursion.native import builder_to_r1cs

    builder = _round1(cfg["example"], g)
    r1cs, _ = builder_to_r1cs(builder)
    ir, inputs = compile_nodes(convert_constraints_to_nodes(r1cs.constraints),
                               width_limit=1)
    if len(ir) != 1:
        raise ValueError(f"round 1 compiled to {len(ir)} circuits at width limit 1")
    compiled = _ir_to_circuit(ir[0], len(inputs[0]))
    circ = {"layers": [(layer.k_cur, layer.k_next, _cols(layer.add_gates),
                        _cols(layer.mult_gates)) for layer in compiled.layers],
            "input_k": compiled.input_k,
            "inputs": inputs[0],
            "constraints": len(builder.constraints),
            "example": cfg["example"]}
    check_pins(cfg, circ)
    return circ


def witness(circ: dict, g: np.random.Generator) -> list[list[int]]:
    """The tables W_0 .. W_depth of a round 1 drawn from g; W_0 is asserted
    zero."""
    from gkr_tpu_torch.frontend.compiler import _input_values

    builder = _round1(circ["example"], g)
    if len(builder.constraints) != circ["constraints"]:
        raise ValueError(f"round 1 has {len(builder.constraints)} constraints, "
                         f"the compiled circuit {circ['constraints']}")
    w = evaluate(circ["layers"], _input_values(circ["inputs"], builder.witness))
    if any(w[0]):
        raise AssertionError("round 1's output table (the constraints' residuals) "
                             "is not zero")
    return w
