"""The port's circom interpreter (gkr_tpu_torch.recursion.circom_interp) on
the port's circuits (gkr_tpu_torch/circuits), case for case as
tests/test_circom_interp.py runs gkr_tpu's.

The port's interpreter is gkr_tpu's program, statement for statement (its
module docstring aside; `test_the_interpreter_is_gkr_tpus`).  The small
accepting runs and every failing run go through both interpreters on the
same file and inputs (`run_both`): the port's outputs and constraint
count must equal gkr_tpu's, and where one raises, the other must raise
the same error class with the same message.  The three large accepting
runs (12 embedded verifiers each, ~1 s an interpreter) go through the
port's alone and are checked by their outputs and constraint counts, as
the reference's test checks them: run twice, they would take this file
past its share of the suite's clock.  The strong gadget's inputs come
from the port's own proofs, frontend and templating."""

import ast
import copy
import json
import os
from pathlib import Path

import pytest

from gkr_tpu.recursion import circom_interp as jax_interp

from gkr_tpu_torch import Proof, TorchBackend, prove
from gkr_tpu_torch.field import P
from gkr_tpu_torch.frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
from gkr_tpu_torch.mimc import Mimc7
from gkr_tpu_torch.recursion.circom_interp import (CircomError, ConstraintFailure,
                                                   run_circuit)
from gkr_tpu_torch.recursion.serialize import (CircomInputProof, get_meta,
                                               modify_proof_for_circom,
                                               write_aggregated_input)
from gkr_tpu_torch.recursion.templating import modify_circom_file, structural_lens

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "circom_mimc")
CIRCUITS = os.path.join(REPO, "gkr_tpu_torch", "circuits")
EXAMPLES = os.path.join(REPO, "examples", "mimc")


def run_both(path, inputs, include_dirs=None):
    """The port's run_circuit, held to gkr_tpu's on the same file and
    inputs: the same (outputs, constraints checked), or the same error
    class and message, which is then raised."""
    def attempt(run, errors):
        try:
            return run(path, copy.deepcopy(inputs), include_dirs=include_dirs), None
        except errors as e:
            return None, e

    got, err = attempt(run_circuit, CircomError)
    want, jax_err = attempt(jax_interp.run_circuit, jax_interp.CircomError)
    if err is None:
        assert jax_err is None, f"gkr_tpu's interpreter raised {jax_err!r}"
        assert got == want
        return got
    assert jax_err is not None, f"only the port's interpreter raised {err!r}"
    assert (type(err).__name__, str(err)) == (type(jax_err).__name__, str(jax_err))
    raise err


def test_the_interpreter_is_gkr_tpus():
    """The same statements as gkr_tpu's interpreter, on the port's `field`
    and `mimc` (the same relative imports); only the module docstring
    differs."""
    def code(path):
        tree = ast.parse(Path(path).read_text())
        assert isinstance(tree.body[0].value, ast.Constant)     # the docstring
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert code(REPO + "/gkr_tpu_torch/recursion/circom_interp.py") == \
        code(REPO + "/gkr_tpu/recursion/circom_interp.py")


def _agg_inputs():
    with open(os.path.join(FIX, "aggregated.json")) as f:
        return json.load(f)


def test_example_circuit_executes():
    with open(os.path.join(EXAMPLES, "input1.json")) as f:
        inputs = json.load(f)
    out, n = run_both(os.path.join(EXAMPLES, "circuit.circom"), inputs)
    assert out["out"] == Mimc7().hash(int(inputs["in1"]), 0)
    assert n >= 3


def test_committed_aggregated_circom_executes():
    """The byte-golden aggregated.circom (12 embedded VerifyGKR instances)
    against its committed aggregated.json, on the port's verifier circuit."""
    inputs = _agg_inputs()
    out, n = run_circuit(os.path.join(FIX, "aggregated.circom"), inputs,
                         include_dirs=[CIRCUITS])
    assert out["out"] == Mimc7().hash(int(inputs["in1"]), 0)
    assert n > 50_000


def test_committed_aggregated_multi_executes():
    """The multi-template variant (main template not first in file)."""
    inputs = _agg_inputs()
    out, _ = run_circuit(os.path.join(FIX, "aggregated_multi.circom"), inputs,
                         include_dirs=[CIRCUITS])
    assert out["out"] == (int(inputs["in1"]) ** 2 + int(inputs["in2"])) % P


def test_corrupted_witness_fails():
    inputs = _agg_inputs()
    inputs["sumcheckProof3"][1][2][1] = str(int(inputs["sumcheckProof3"][1][2][1]) + 1)
    with pytest.raises(ConstraintFailure):
        run_both(os.path.join(FIX, "aggregated.circom"), inputs,
                 include_dirs=[CIRCUITS])


def test_corrupted_circuit_text_fails(tmp_path):
    """One operator flipped in the port's verifier circuit must fail."""
    with open(os.path.join(CIRCUITS, "gkr_verifier.circom")) as f:
        src = f.read()
    bad = src.replace("at0[j].out + at1[j].out === expected[j];",
                      "at0[j].out - at1[j].out === expected[j];")
    assert bad != src
    (tmp_path / "gkr_verifier.circom").write_text(bad)
    with open(os.path.join(FIX, "aggregated.circom")) as f:
        (tmp_path / "aggregated.circom").write_text(f.read())
    with pytest.raises(ConstraintFailure):
        run_both(str(tmp_path / "aggregated.circom"), _agg_inputs())


def test_garbled_circuit_text_is_a_parse_error(tmp_path):
    with open(os.path.join(FIX, "aggregated.circom")) as f:
        agg = f.read()
    (tmp_path / "aggregated.circom").write_text(
        agg.replace("for (var a = 0;", "for (var a = 0", 1))
    with open(os.path.join(CIRCUITS, "gkr_verifier.circom")) as f:
        (tmp_path / "gkr_verifier.circom").write_text(f.read())
    with pytest.raises(CircomError):
        run_both(str(tmp_path / "aggregated.circom"), _agg_inputs())


def test_gate_code_template(tmp_path):
    """GkrEvalGateCode: code t in {0, 1, 2} selects {1, 1 - x, x}."""
    wrapper = """pragma circom 2.0.0;
include "gkr_verifier.circom";
template T() {
    signal input code;
    signal input x;
    signal output out;
    component g = GkrEvalGateCode();
    g.code <== code;
    g.x <== x;
    out <== g.out;
}
component main = T();
"""
    (tmp_path / "wrap.circom").write_text(wrapper)
    x = 1234567
    for code, expect in ((0, 1), (1, (1 - x) % P), (2, x)):
        out, _ = run_both(str(tmp_path / "wrap.circom"), {"code": code, "x": x},
                          include_dirs=[CIRCUITS])
        assert out["out"] == expect, code


@pytest.fixture(scope="module")
def fixture_proofs():
    """The committed r1cs/wtns fixture's subcircuits, proved by the port on
    the CPU (JSON dicts: each test loads its own copy)."""
    r1cs = R1csFile.read(os.path.join(FIX, "circuit.r1cs"))
    wtns = WtnsFile.read(os.path.join(FIX, "witness.wtns"))
    circuits, w_values, _public = compile_r1cs_to_gkr(r1cs, wtns)
    backend = TorchBackend(device="cpu")
    return [prove(c, w, backend=backend).to_dict() for c, w in zip(circuits, w_values)]


def _strong_inputs(proofs, tmp_path):
    """The port's templating of the strong gadget over `proofs`: the
    aggregated circuit's path and its inputs."""
    metas = get_meta(proofs)
    padded = modify_proof_for_circom(proofs, metas)
    agg_json = write_aggregated_input(
        os.path.join(EXAMPLES, "input1.json"), [CircomInputProof(p) for p in padded],
        str(tmp_path / "aggregated.json"))
    agg_circ = modify_circom_file(
        os.path.join(EXAMPLES, "circuit.circom"), metas,
        str(tmp_path / "aggregated.circom"), lens=structural_lens(proofs))
    with open(agg_json) as f:
        return agg_circ, json.load(f)


def test_strong_fs_circuit_executes(fixture_proofs, tmp_path):
    """gkr_verifier_fs.circom (VerifyGKRStrongFS) over the port's proofs of
    the fixture: in-circuit MiMC7 Fiat-Shamir, r*, the z-chain and the
    z_0 = 0 binding all hold."""
    proofs = [Proof.from_dict(d) for d in fixture_proofs]
    agg_circ, inputs = _strong_inputs(proofs, tmp_path)
    with open(agg_circ) as f:
        text = f.read()
    assert "VerifyGKRStrongFS(" in text and "gkr_verifier_fs.circom" in text
    out, n = run_circuit(agg_circ, inputs, include_dirs=[CIRCUITS])
    assert out["out"] == Mimc7().hash(int(inputs["in1"]), 0)
    assert n > 60_000


def test_strong_fs_rejects_forged_challenge(fixture_proofs, tmp_path):
    """A self-chosen challenge fails the in-circuit Fiat-Shamir."""
    proofs = [Proof.from_dict(fixture_proofs[0])]
    proofs[0].sumcheck_r[0][1] = proofs[0].sumcheck_r[0][1] + 1
    agg_circ, inputs = _strong_inputs(proofs, tmp_path)
    with pytest.raises(ConstraintFailure):
        run_both(agg_circ, inputs, include_dirs=[CIRCUITS])
