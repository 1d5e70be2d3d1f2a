"""Example circuits.

`mimc_example` replicates the reference's example circuit `rust/t.circom`
(out <== MiMC7(91)(in1, 0), public in1) natively, usable with the native
aggregation flow against the reference's example inputs
(rust/example/input{1,2,3}.json)."""

from __future__ import annotations

from .recursion.native import LC, ConstraintBuilder, mimc7_gadget


def mimc_example(b: ConstraintBuilder, inputs: dict) -> None:
    in1 = LC.var(b.alloc(int(inputs["in1"])))
    b.alloc(int(inputs.get("in2", 0)))  # declared but unused, like t.circom
    out = mimc7_gadget(b, in1, LC.const(0))
    out_wire = b.mul(out, LC.const(1))   # materialize the output wire
    b.assert_eq(out_wire, out)


def square_chain_example(b: ConstraintBuilder, inputs: dict,
                         rounds: int = 2) -> None:
    """Tiny quadratic example: out = in1^(2^rounds)."""
    x = LC.var(b.alloc(int(inputs["in1"])))
    for _ in range(rounds):
        x = b.mul(x, x)
