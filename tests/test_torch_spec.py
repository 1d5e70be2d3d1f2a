"""The port's spec prover (gkr_tpu_torch.spec) against gkr_tpu's on the CPU:
the sparse-symbolic `prove_spec` equals gkr_tpu's and the port's dense host
engine on small circuits, and the generic textbook sumcheck proves and
verifies as in test_gkr_e2e.py.  Field arithmetic is exact: proofs must be
identical."""

import random

import pytest

from gkr_tpu import Mimc7 as JaxMimc7
from gkr_tpu.spec import prove_spec as jax_prove_spec
from gkr_tpu.spec import prove_sumcheck_generic as jax_generic

import gkr_tpu_torch as port
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.field import P, eval_univariate
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.spec import (prove_spec, prove_sumcheck_generic,
                                verify_sumcheck_generic)
from gkr_tpu_torch.spec.gkr_spec import partial_eval

from test_gkr_e2e import (assert_proofs_identical, random_circuit,
                          reference_toy_circuit)


def circuit(case):
    if case == "toy":
        return reference_toy_circuit()
    if case == "random":
        return random_circuit(random.Random(5), depth=3)
    return random_circuit(random.Random(11), depth=2, degenerate=True)


@pytest.mark.parametrize("case", ["toy", "random", "degenerate"])
@pytest.mark.parametrize("with_z0", [False, True])
def test_prove_spec_matches_gkr_tpu_and_host_engine(case, with_z0):
    c, inputs = circuit(case)
    z0 = ([random.Random(99).randrange(P) for _ in range(c.k(0))]
          if with_z0 else None)
    pc = circuit_from(c)
    w = pc.evaluate(inputs)
    got = prove_spec(pc, w, z0=z0)
    assert_proofs_identical(got, jax_prove_spec(c, c.evaluate(inputs), z0=z0))
    assert_proofs_identical(got, port.prove(pc, w, z0=z0,
                                            backend=port.HostBackend()))
    assert port.verify(got, pc, raise_on_fail=True)


def test_generic_sumcheck_prove_verify():
    """test_gkr_e2e.py's generic sumcheck case on the port, its transcript
    equal to gkr_tpu's."""
    rng = random.Random(7)
    for v, nterms, maxdeg in [(2, 3, 1), (3, 5, 2), (4, 8, 3)]:
        g = [[rng.randrange(1, P)] + [rng.randrange(maxdeg + 1)
                                      for _ in range(v)]
             for _ in range(nterms)]
        claim = 0
        for a_int in range(1 << v):
            a = [(a_int >> (v - 1 - i)) & 1 for i in range(v)]
            claim = (claim + partial_eval(g, a)[0][0]
                     + sum(t[0] for t in partial_eval(g, a)[1:])) % P
        proof, r = prove_sumcheck_generic(g, v, Mimc7())
        assert (proof, r) == jax_generic(g, v, JaxMimc7())
        assert verify_sumcheck_generic(claim, proof, r, v, Mimc7())
        full = partial_eval(g, r)
        assert eval_univariate(proof[-1], r[-1]) == sum(row[0] for row in full) % P
        assert not verify_sumcheck_generic((claim + 1) % P, proof, r, v, Mimc7())
