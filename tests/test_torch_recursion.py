"""The port's recursion (serialization, templating, native aggregation, the
circom-path round loop, the toolchain drivers) and the port bench's
aggregation cell against gkr_tpu's, on the CPU.

Proofs are made with the host engine, which is exact: exported .r1cs/.wtns
files, templated .circom, aggregated.json and built constraint systems must
equal gkr_tpu's byte for byte or term for term.  The full-strength
aggregation at its real size runs on the card only (chip_smoke.py [11]);
here one strong round is built over a tiny round-0 proof, not proved."""

import json
import os
import re
import time
from pathlib import Path

import pytest
import torch

from gkr_tpu import examples as JE
from gkr_tpu.recursion import native as JN
from gkr_tpu.recursion import serialize as JS
from gkr_tpu.recursion import templating as JT

from gkr_tpu_torch import HostBackend, bench
from gkr_tpu_torch import examples as E
from gkr_tpu_torch.field import P
from gkr_tpu_torch.frontend.r1cs import R1csFile
from gkr_tpu_torch.frontend.symfile import write_sym
from gkr_tpu_torch.frontend.wtns import WtnsFile
from gkr_tpu_torch.proof import Proof
from gkr_tpu_torch.recursion import aggregator as A
from gkr_tpu_torch.recursion import circom_driver as D
from gkr_tpu_torch.recursion import native as N
from gkr_tpu_torch.recursion import serialize as S
from gkr_tpu_torch.recursion import templating as T

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures" / "circom_mimc"
EXAMPLE = ROOT / "examples" / "mimc"
SQUARE_INPUTS = [{"in1": 3}, {"in1": 5}, {"in1": 7}]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small tables nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_proofs(tmp_path_factory):
    """The port's convert + prove (host engine, self-verified) over the
    committed circom files, as the aggregator's first round runs it."""
    work = tmp_path_factory.mktemp("fixture")
    for name in ("circuit.r1cs", "circuit.sym", "witness.wtns"):
        (work / name).write_bytes((FIX / name).read_bytes())
    proofs = A._convert_and_prove("circuit", ".", "input1", str(work),
                                  backend=HostBackend())
    assert json.loads((work / "input1_output.json").read_text()) == {"in1": "2"}
    return proofs


# ------------------------------------------------------------- circom files

@pytest.mark.parametrize("name", ["gkr_verifier.circom", "gkr_verifier_fs.circom"])
def test_verifier_circuits_are_gkr_tpus(name):
    got = (ROOT / "gkr_tpu_torch" / "circuits" / name).read_bytes()
    assert got == (ROOT / "gkr_tpu" / "circuits" / name).read_bytes()
    assert Path({"gkr_verifier.circom": T.VERIFIER_CIRCUIT,
                 "gkr_verifier_fs.circom": T.FS_VERIFIER_CIRCUIT}[name]) == \
        ROOT / "gkr_tpu_torch" / "circuits" / name


@pytest.mark.parametrize("user, golden", [
    (EXAMPLE / "circuit.circom", "aggregated.circom"),
    (FIX / "multi_template.circom", "aggregated_multi.circom")])
def test_templating_goldens(fixture_proofs, tmp_path, user, golden):
    """modify_circom_file gives the committed goldens' bytes with their
    include; by default the include names the port's own verifier copy (the
    strong one with structural lengths)."""
    metas = S.get_meta(fixture_proofs)
    out = T.modify_circom_file(str(user), metas, str(tmp_path / golden),
                               verifier_include="gkr_verifier.circom")
    assert Path(out).read_bytes() == (FIX / golden).read_bytes()
    for lens, path in ((None, T.VERIFIER_CIRCUIT),
                       (T.structural_lens(fixture_proofs), T.FS_VERIFIER_CIRCUIT)):
        out = T.modify_circom_file(str(user), metas, str(tmp_path / "default.circom"),
                                   lens=lens)
        assert f'include "{path}";' in Path(out).read_text().splitlines()


def test_aggregated_input_golden(fixture_proofs, tmp_path):
    metas = S.get_meta(fixture_proofs)
    assert metas == JS.get_meta([JS.Proof.from_dict(p.to_dict()) for p in fixture_proofs])
    cips = [S.CircomInputProof(p)
            for p in S.modify_proof_for_circom(fixture_proofs, metas)]
    out = S.write_aggregated_input(str(EXAMPLE / "input2.json"), cips,
                                   str(tmp_path / "aggregated.json"))
    assert Path(out).read_bytes() == (FIX / "aggregated.json").read_bytes()


# ------------------------------------------------------- native aggregation

def test_weak_native_aggregation_exports_gkr_tpus_bytes(tmp_path):
    """Three weak-gadget rounds of the square chain (the verify skill's CLI
    smoke): the final proofs and the exported .r1cs/.wtns equal gkr_tpu's."""
    kw = dict(full_fs=False, recombination=False, check_verify=False)
    got = N.prove_all_native(E.square_chain_example, SQUARE_INPUTS,
                             backend=HostBackend(),
                             export_final=str(tmp_path / "port"), **kw)
    want = JN.prove_all_native(JE.square_chain_example, SQUARE_INPUTS,
                               export_final=str(tmp_path / "jax"), **kw)
    assert [json.dumps(p.to_dict()) for p in got] == \
        [json.dumps(p.to_dict()) for p in want]
    for ext in ("r1cs", "wtns"):
        port_bytes = (tmp_path / f"port.{ext}").read_bytes()
        assert port_bytes == (tmp_path / f"jax.{ext}").read_bytes()
    assert len(R1csFile.read(str(tmp_path / "port.r1cs")).constraints) == 4403


def strong_round1(native, examples, pairs):
    """Round 1's builder with the full-strength gadget (full_fs, structural
    shape, wiring recombination) over round 0's (proof, circuit) pairs, as
    prove_round_native builds it, without compiling or proving."""
    serialize = S if native is N else JS
    b = native.ConstraintBuilder()
    examples.square_chain_example(b, SQUARE_INPUTS[1])
    proofs = [p for p, _ in pairs]
    metas = serialize.get_meta(proofs)
    padded = serialize.modify_proof_for_circom(proofs, metas)
    for (proof, circ), pp, meta in zip(pairs, padded, metas):
        native.verify_gkr_gadget(b, pp, meta, circuit=circ, full_fs=True,
                                 shape=native.proof_shape(proof))
    return b


def test_strong_round1_gadget_builds_gkr_tpus_r1cs():
    """Round 0 proved by both packages (the default strong settings), then
    round 1's full-strength gadget built by each: the same constraints,
    witness and R1CS header."""
    got0, _ = N.prove_round_native(E.square_chain_example, SQUARE_INPUTS[0],
                                   backend=HostBackend())
    want0, _ = JN.prove_round_native(JE.square_chain_example, SQUARE_INPUTS[0])
    assert [json.dumps(p.to_dict()) for p, _ in got0] == \
        [json.dumps(p.to_dict()) for p, _ in want0]
    got, want = strong_round1(N, E, got0), strong_round1(JN, JE, want0)
    assert got.constraints == want.constraints
    assert got.witness == want.witness
    assert len(got.constraints) == 15488
    (gr, gw), (wr, ww) = N.builder_to_r1cs(got), JN.builder_to_r1cs(want)
    assert vars(gr.header) == vars(wr.header) and gw.values == ww.values


def test_r1cs_writer_is_linear(tmp_path):
    """Writing round 1's 15,488 strong constraints takes well under a second
    (gkr_tpu's writer appends to one bytes object, quadratic in its size),
    and parses back to the same system."""
    pairs, _ = N.prove_round_native(E.square_chain_example, SQUARE_INPUTS[0],
                                    backend=HostBackend())
    b = strong_round1(N, E, pairs)
    path = str(tmp_path / "round1.r1cs")
    t0 = time.perf_counter()
    R1csFile.write(path, P, n_wires=len(b.witness), n_pub_out=0, n_pub_in=0,
                   n_prv_in=len(b.witness) - 1, constraints=b.constraints)
    assert time.perf_counter() - t0 < 5
    back = R1csFile.read(path)
    assert back.constraints == [tuple(c) for c in b.constraints]


# ------------------------------------------------- circom path, fake tools

_META_RE = re.compile(r"VerifyGKR\(\[([0-9,\s]+)\]\)")
_SQUARE_CIRCOM = """\
pragma circom 2.0.0;

template SquareChain() {
    signal input in1;
    signal input in2;
    signal output out;

    signal mid;
    mid <== in1 * in1;
    out <== mid * mid;
}

component main {public [in1]} = SquareChain();
"""


def _fake_execute_circom(circuit_path: str, input_path: str, workdir: str = "."):
    """Stand-in for circom + node, built from the port's modules: the
    constraint system the generated .circom describes (the user circuit and
    one reference-parity VerifyGKR gadget per meta parsed from its text),
    written in circom's r1cs/sym/wtns formats."""
    with open(input_path) as f:
        inputs = json.load(f)
    src = Path(circuit_path).read_text()
    metas = [[int(x) for x in m.group(1).split(",")] for m in _META_RE.finditer(src)]
    b = N.ConstraintBuilder()
    (E.square_chain_example if "SquareChain" in src else E.mimc_example)(b, inputs)
    b.n_public = 1
    ii = lambda v: int(v) % P  # noqa: E731
    for i, meta in enumerate(metas):
        proof = Proof(
            sumcheck_proofs=[[[ii(c) for c in rnd] for rnd in layer]
                             for layer in inputs[f"sumcheckProof{i}"]],
            sumcheck_r=[[ii(c) for c in layer] for layer in inputs[f"sumcheckr{i}"]],
            d=[[ii(c) for c in t] for t in inputs[f"D{i}"]],
            q=[[ii(c) for c in qq] for qq in inputs[f"q{i}"]],
            z=[[ii(c) for c in zz] for zz in inputs[f"z{i}"]],
            r=[ii(c) for c in inputs[f"r{i}"]],
            depth=meta[0],
            input_func=[[ii(c) for c in t] for t in inputs[f"inputFunc{i}"]],
            k=meta[8:])
        N.verify_gkr_gadget(b, proof, meta, full_fs=False)
    name = os.path.splitext(os.path.basename(circuit_path))[0]
    R1csFile.write(os.path.join(workdir, f"{name}.r1cs"), P,
                   n_wires=len(b.witness), n_pub_out=0, n_pub_in=1,
                   n_prv_in=len(b.witness) - 2, constraints=b.constraints)
    write_sym(os.path.join(workdir, f"{name}.sym"), ["in1"])
    WtnsFile.write(os.path.join(workdir, "witness.wtns"), P, b.witness)
    return name, ""


def _prove_all_with_fake_toolchain(agg, fake, workdir, monkeypatch, **kw):
    """`agg.prove_all` of the square circuit over examples/mimc/input1..3,
    with circom and node replaced by `fake` and subcircuits cut at width 2
    (as the JAX package's test runs it); returns the proofs' JSON and the
    round files' bytes."""
    real_compile = agg.compile_r1cs_to_gkr
    monkeypatch.setattr(agg, "compile_r1cs_to_gkr",
                        lambda r1cs, wtns, sym_names=None, **k: real_compile(
                            r1cs, wtns, sym_names, **{**k, "width_limit": 2}))
    monkeypatch.setattr(agg, "execute_circom", fake)
    circuit = workdir / "square.circom"
    circuit.write_text(_SQUARE_CIRCOM)
    inputs = [str(EXAMPLE / f"input{i}.json") for i in (1, 2, 3)]
    proofs = agg.prove_all(str(circuit), inputs, workdir=str(workdir), **kw)
    files = {name: (workdir / name).read_bytes()
             for name in ("aggregated.circom", "aggregated.json", "witness.wtns")}
    return [json.dumps(p.to_dict()) for p in proofs], files


def test_prove_all_fake_toolchain(tmp_path, monkeypatch):
    """The circom path's 3-input round loop (round 0 direct, round 1 through
    templating and aggregated.json, round 2 the groth templating) with the
    circom and node subprocesses replaced by the emulator above, on the
    host engine, against gkr_tpu's `prove_all` with its own emulator
    (tests/test_circom_fixture.py) on gkr_tpu's host engine: the same
    proofs as JSON, and the same aggregated.json, witness.wtns and
    aggregated.circom bytes but for the include, which names each
    package's own verifier copy."""
    import gkr_tpu.recursion.aggregator as JA
    from gkr_tpu.prover import HostBackend as JaxPackageHostBackend
    from test_circom_fixture import _fake_execute_circom as jax_package_fake

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    proofs, files = _prove_all_with_fake_toolchain(
        A, _fake_execute_circom, tmp_path / "port", monkeypatch,
        backend=HostBackend())
    ref_proofs, ref_files = _prove_all_with_fake_toolchain(
        JA, jax_package_fake, tmp_path / "ref", monkeypatch,
        backend=JaxPackageHostBackend())
    assert proofs and proofs == ref_proofs
    for name in ("aggregated.json", "witness.wtns"):
        assert files[name] == ref_files[name], name
    lines = files["aggregated.circom"].decode().splitlines()
    ref_lines = ref_files["aggregated.circom"].decode().splitlines()
    assert f'include "{T.VERIFIER_CIRCUIT}";' in lines
    assert f'include "{JT.VERIFIER_CIRCUIT}";' in ref_lines
    assert [l for l in lines if not l.startswith("include ")] == \
        [l for l in ref_lines if not l.startswith("include ")]


def test_toolchain_missing_raises(tmp_path, monkeypatch):
    """Without circom, node and snarkjs on PATH the circom path and the
    groth16 hand-off raise ToolchainMissing; nothing is installed."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not D.toolchain_available()
    with pytest.raises(D.ToolchainMissing, match="circom"):
        D.execute_circom(str(EXAMPLE / "circuit.circom"),
                         str(EXAMPLE / "input1.json"), str(tmp_path))
    with pytest.raises(D.ToolchainMissing, match="snarkjs"):
        D.mock_groth("circuit.zkey", str(tmp_path))


# ------------------------------------------------------------ bench cell

def test_run_aggregation_one_round_on_cpu():
    """The port bench's aggregation_e2e cell, its first round (the mimc
    example proved directly) on the CPU: bench.py's keys, gkr_tpu's
    constraint count, every stage timed and logged as it ends."""
    lines = []
    out = bench.run_aggregation(1, device="cpu", log=lines.append)
    assert set(out) == {"config", "total_s", "round_s", "constraints", "stage_s"}
    b = JN.ConstraintBuilder()
    JE.mimc_example(b, {"in1": 2, "in2": 3})
    assert out["constraints"] == [len(b.constraints)] == [366]
    assert len(out["round_s"]) == 1 and out["round_s"][0] > 0 and out["total_s"] > 0
    (stages,) = out["stage_s"]
    assert list(stages) == list(bench.STAGES)
    assert all(v > 0 for v in stages.values())
    assert sum(stages.values()) == pytest.approx(out["round_s"][0], abs=0.01)
    assert [l.split(":")[0].strip() for l in lines] == \
        ["round 0", "gadget build", "compile", "prove", "self-verify", "round 0"]


def test_aggregation_round_is_prove_round_native():
    """The bench's stage-timed round gives `prove_round_native`'s proofs,
    circuits, constraints and witness: round 0 of the mimc example on the
    port's host engine (a full-strength round 1 compiles for ~25 s here;
    chip_smoke.py [11] drives it on the card)."""
    with open(EXAMPLE / "input1.json") as f:
        user_input = {k: int(v) for k, v in json.load(f).items()}
    backend = HostBackend()
    pairs, b, st = bench.aggregation_round(E.mimc_example, user_input,
                                           backend=backend, device="cpu")
    ref_pairs, ref_b = N.prove_round_native(E.mimc_example, user_input,
                                            backend=backend)
    assert b.constraints == ref_b.constraints and b.witness == ref_b.witness
    assert [json.dumps(p.to_dict()) for p, _ in pairs] == \
        [json.dumps(p.to_dict()) for p, _ in ref_pairs]
    assert [c.k_list() for _, c in pairs] == [c.k_list() for _, c in ref_pairs]
    assert st["constraints"] == len(b.constraints) and st["launches"] == {}
