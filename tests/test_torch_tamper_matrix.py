"""The tamper matrix of tests/test_tamper_matrix.py on the port's two
in-circuit verifier executors: the port's circom interpreter running the
port's templated verifier circuits (gkr_tpu_torch/circuits), and the port's
native gadget (`recursion.native.verify_gkr_gadget`).  The proofs are made
by the port's prove() on the CPU.

For every proof field (round coefficients, q, z, r, sumcheckr, D,
input_func) one value is tampered: the STRONG executors (full_fs gadget,
VerifyGKRStrongFS circuit) must both reject, and the WEAK ones
(reference-parity gadget, VerifyGKR circuit with free challenges) must
agree with each other.  A self-consistent transcript with forged
challenges is accepted by both weak executors and rejected by both strong
ones."""

import functools
import json
import os
import tempfile

import pytest

from gkr_tpu_torch import TorchBackend, prove
from gkr_tpu_torch.circuit import GateLayer, GKRCircuit
from gkr_tpu_torch.convert import circuit_from
from gkr_tpu_torch.field import P
from gkr_tpu_torch.frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.recursion.circom_interp import ConstraintFailure, run_circuit
from gkr_tpu_torch.recursion.native import (ConstraintBuilder, proof_shape,
                                            verify_gkr_gadget)
from gkr_tpu_torch.recursion.serialize import (CircomInputProof, get_meta,
                                               modify_proof_for_circom,
                                               write_aggregated_input)
from gkr_tpu_torch.recursion.templating import modify_circom_file, structural_lens

from test_gkr_e2e import reference_toy_circuit
from test_tamper_matrix import TAMPERS

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "circom_mimc")
CIRCUITS = os.path.join(REPO, "gkr_tpu_torch", "circuits")
EXAMPLES = os.path.join(REPO, "examples", "mimc")


class _EvilTranscript(Mimc7):
    """Every challenge is the true hash + 12345: self-consistent (the prover
    folds with exactly these values) but fails any Fiat-Shamir
    recomputation."""

    def multi_hash(self, xs, key=0):
        return (super().multi_hash(xs, key) + 12345) % P


def _cpu_prove(circuit, w, transcript=None):
    return prove(circuit, w, transcript=transcript or Mimc7(),
                 backend=TorchBackend(device="cpu"))


@functools.lru_cache(maxsize=1)
def _fixture_circuit():
    """Subcircuit 0 of the committed r1cs/wtns fixture and its values."""
    r1cs = R1csFile.read(os.path.join(FIX, "circuit.r1cs"))
    wtns = WtnsFile.read(os.path.join(FIX, "witness.wtns"))
    circuits, w_values, _public = compile_r1cs_to_gkr(r1cs, wtns)
    return circuits[0], w_values[0]


def _prove_fixture(transcript=None):
    circuit, w = _fixture_circuit()
    return _cpu_prove(circuit, w, transcript), circuit


def _make_base(proof, circuit, tag):
    """Honest proof + both templated circuit texts (values do not change
    shapes, so one circuit text serves every tampered json)."""
    metas = get_meta([proof])
    d = tempfile.mkdtemp(prefix=f"torch_tamper_{tag}_")
    strong = modify_circom_file(os.path.join(EXAMPLES, "circuit.circom"), metas,
                                os.path.join(d, "strong.circom"),
                                lens=structural_lens([proof]))
    weak = modify_circom_file(os.path.join(EXAMPLES, "circuit.circom"), metas,
                              os.path.join(d, "weak.circom"))
    return {"proof": proof, "circuit": circuit, "metas": metas,
            "dir": d, "strong": strong, "weak": weak}


@pytest.fixture(scope="module")
def base():
    return _make_base(*_prove_fixture(), "mimc")


@pytest.fixture(scope="module")
def base_padmix():
    """Real coefficient padding: the input table [5, 7, 5, 7] leaves x_1
    unsupported, so the add-only layer's round polys have structural
    length 2, front-padded to the proof-wide 3."""
    l0 = GateLayer(1, 2, mult_gates=[(0, 0, 1), (1, 2, 3)])
    l1 = GateLayer(2, 2, add_gates=[(0, 0, 1), (1, 1, 2), (2, 2, 3), (3, 3, 0)])
    circuit = GKRCircuit(layers=[l0, l1], input_k=2)
    return _make_base(_cpu_prove(circuit, circuit.evaluate([5, 7, 5, 7])),
                      circuit, "padmix")


@pytest.fixture(scope="module")
def base_toy():
    """The reference toy circuit: nonzero outputs (a nonempty sparse D) and
    heterogeneous layer sizes (real padding prefixes)."""
    c, inputs = reference_toy_circuit()
    circuit = circuit_from(c)
    return _make_base(_cpu_prove(circuit, circuit.evaluate(inputs)), circuit, "toy")


def _interp_inputs(base, padded, tag):
    path = write_aggregated_input(
        os.path.join(EXAMPLES, "input1.json"), [CircomInputProof(padded)],
        os.path.join(base["dir"], f"agg_{tag}.json"))
    with open(path) as f:
        return json.load(f)


def _interp_accepts(circ_path, inputs):
    try:
        run_circuit(circ_path, inputs, include_dirs=[CIRCUITS])
        return True
    except ConstraintFailure:
        return False


def _gadget_accepts(base, padded, full_fs):
    try:
        verify_gkr_gadget(ConstraintBuilder(), padded, base["metas"][0],
                          circuit=base["circuit"] if full_fs else None,
                          full_fs=full_fs,
                          shape=proof_shape(base["proof"]) if full_fs else None)
        return True
    except AssertionError:
        return False


def _padded(base, proof=None):
    return modify_proof_for_circom([proof or base["proof"]], base["metas"])[0]


def _weak_agree(base, padded, inputs, what):
    g = _gadget_accepts(base, padded, full_fs=False)
    c = _interp_accepts(base["weak"], inputs)
    assert g == c, (f"weak executors diverge on {what}: "
                    f"gadget={'accept' if g else 'reject'} "
                    f"circuit={'accept' if c else 'reject'}")


def test_honest_proof_accepted_everywhere(base):
    padded = _padded(base)
    assert _gadget_accepts(base, padded, full_fs=True)
    assert _gadget_accepts(base, padded, full_fs=False)
    inputs = _interp_inputs(base, padded, "honest")
    assert _interp_accepts(base["strong"], inputs)
    assert _interp_accepts(base["weak"], inputs)


@pytest.mark.parametrize("which", ["mimc", "toy", "padmix"])
@pytest.mark.parametrize("field_name", sorted(TAMPERS))
def test_tamper_matrix(base, base_toy, base_padmix, field_name, which):
    base = {"mimc": base, "toy": base_toy, "padmix": base_padmix}[which]
    padded = _padded(base)
    field = {"coeffs": padded.sumcheck_proofs, "d": padded.d}.get(field_name)
    if field is not None and not (field and field[0]):
        pytest.skip(f"padded proof has no {field_name} rows to tamper")
    TAMPERS[field_name](padded)
    assert not _gadget_accepts(base, padded, full_fs=True), \
        f"strong gadget accepted tampered {field_name}"
    inputs = _interp_inputs(base, padded, field_name)
    assert not _interp_accepts(base["strong"], inputs), \
        f"strong circuit accepted tampered {field_name}"
    _weak_agree(base, padded, inputs, f"tampered {field_name}")


def test_padding_tamper_strong_rejects(base_padmix):
    """A fake high-degree coefficient in a round poly's padding prefix: the
    strong executors pin every padding wire to zero."""
    base = base_padmix
    padded = _padded(base)
    shape = proof_shape(base["proof"])
    target = next(rnd for i, layer in enumerate(padded.sumcheck_proofs)
                  for j, rnd in enumerate(layer)
                  if j < len(shape.round_lens[i])
                  and len(rnd) - shape.round_lens[i][j] > 0)
    target[0] = (target[0] + 1) % P
    assert not _gadget_accepts(base, padded, full_fs=True)
    inputs = _interp_inputs(base, padded, "padsmuggle")
    assert not _interp_accepts(base["strong"], inputs)
    _weak_agree(base, padded, inputs, "padding tamper")


def test_forged_transcript_weak_accepts_strong_rejects(base):
    """Forged but self-consistent challenges: both weak executors accept,
    both strong executors reject at the in-circuit Fiat-Shamir."""
    proof, _circuit = _prove_fixture(transcript=_EvilTranscript())
    assert get_meta([proof]) == base["metas"]
    padded = _padded(base, proof)
    inputs = _interp_inputs(base, padded, "evil")
    assert not _gadget_accepts(base, padded, full_fs=True)
    assert not _interp_accepts(base["strong"], inputs)
    assert _gadget_accepts(base, padded, full_fs=False), \
        "weak gadget rejected a self-consistent transcript"
    assert _interp_accepts(base["weak"], inputs), \
        "weak circuit rejected a self-consistent transcript"
