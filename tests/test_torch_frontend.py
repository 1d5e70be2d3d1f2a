"""The port's frontend, subcircuit proving and CLI against gkr_tpu's, on the
CPU.

The committed circom fixture (tests/fixtures/circom_mimc: circuit.r1cs,
witness.wtns, circuit.sym) goes through both packages' parsers and
compilers; the compiled subcircuits through the port's `prove_subcircuits`
(threads of TorchBackend(device="cpu"), the host process pool) and
gkr_tpu's host `prove`; the fixture through both command lines.  Field
arithmetic is exact: everything must be equal, proofs as JSON bytes."""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import gkr_tpu
from gkr_tpu import cli as jax_cli
from gkr_tpu import frontend as JF

import gkr_tpu_torch as port
from gkr_tpu_torch import cli
from gkr_tpu_torch import frontend as F
from gkr_tpu_torch.field import P
from gkr_tpu_torch.recursion import aggregator as A

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures" / "circom_mimc"
R1CS, WTNS, SYM = (str(FIX / n) for n in ("circuit.r1cs", "witness.wtns", "circuit.sym"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs its files in parallel workers; torch's intra-op threads
    buy these small tables nothing and take cores from the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compiled(mod, width_limit=20):
    r1cs, wtns = mod.R1csFile.read(R1CS), mod.WtnsFile.read(WTNS)
    names = mod.parse_sym(SYM, r1cs.header.n_pub_out + r1cs.header.n_pub_in)
    return mod.compile_r1cs_to_gkr(r1cs, wtns, names, width_limit=width_limit)


def shape(circuit):
    return (circuit.input_k, [(l.k_cur, l.k_next, l.add_gates, l.mult_gates)
                              for l in circuit.layers])


def jax_circuit(pc):
    return gkr_tpu.GKRCircuit(
        [gkr_tpu.GateLayer(l.k_cur, l.k_next, l.add_gates, l.mult_gates)
         for l in pc.layers], pc.input_k)


def host_proof_json(circuit, w):
    """gkr_tpu's host prove() of a port circuit, as JSON."""
    return json.dumps(gkr_tpu.prove(jax_circuit(circuit), w).to_dict())


def run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ------------------------------------------------------------------ files

def test_fixture_files_parse_like_gkr_tpu(tmp_path):
    """Headers, constraints, witness values and public names are equal, and
    both writers give the same bytes."""
    got, want = F.R1csFile.read(R1CS), JF.R1csFile.read(R1CS)
    assert vars(got.header) == vars(want.header)
    assert got.constraints == want.constraints
    gw, ww = F.WtnsFile.read(WTNS), JF.WtnsFile.read(WTNS)
    assert (gw.prime, gw.values) == (ww.prime, ww.values)
    n_public = want.header.n_pub_out + want.header.n_pub_in
    assert F.parse_sym(SYM, n_public) == JF.parse_sym(SYM, n_public) == ["in1"]
    h = want.header
    args = dict(n_wires=h.n_wires, n_pub_out=h.n_pub_out, n_pub_in=h.n_pub_in,
                n_prv_in=h.n_prv_in, constraints=want.constraints)
    F.R1csFile.write(str(tmp_path / "port.r1cs"), P, **args)
    JF.R1csFile.write(str(tmp_path / "jax.r1cs"), P, **args)
    F.WtnsFile.write(str(tmp_path / "port.wtns"), P, ww.values)
    JF.WtnsFile.write(str(tmp_path / "jax.wtns"), P, ww.values)
    for ext in ("r1cs", "wtns"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()


@pytest.mark.parametrize("width_limit", [20, 1])
def test_compile_matches_gkr_tpu(width_limit):
    """The same subcircuits (layers, gates, input width), value tables and
    public outputs, merged to the reference's width and to one subcircuit."""
    got_c, got_w, got_pub = compiled(F, width_limit)
    want_c, want_w, want_pub = compiled(JF, width_limit)
    assert [shape(c) for c in got_c] == [shape(c) for c in want_c]
    assert got_w == want_w
    assert got_pub == want_pub == {1: ("in1", 2)}
    assert len(got_c) == (1 if width_limit == 1 else 12)


# ------------------------------------------------------- subcircuit proving

def test_prove_subcircuits_threads_match_gkr_tpu_host():
    """Two threads, each with its own TorchBackend on the CPU, prove two of
    the fixture's subcircuits (through prove(): the CPU is no card); each
    proof is gkr_tpu's host proof, byte for byte."""
    circuits, ws, _ = compiled(F)
    pick = [5, 6]
    proofs = A.prove_subcircuits(
        [circuits[i] for i in pick], [ws[i] for i in pick],
        backend_factory=lambda: port.TorchBackend(device="cpu"), max_workers=2)
    assert [json.dumps(p.to_dict()) for p in proofs] == \
        [host_proof_json(circuits[i], ws[i]) for i in pick]


def test_host_process_pool_matches_gkr_tpu_host(monkeypatch):
    """A HostBackend takes the spawn process pool (threshold lowered to the
    fixture's size): each child imports the port, proves on the host and
    self-verifies; the proofs are gkr_tpu's."""
    monkeypatch.setattr(A, "PROCESS_MIN_GATES", 0)
    circuits, ws, _ = compiled(F)
    proofs = A.prove_subcircuits(circuits[:3], ws[:3], backend=port.HostBackend(),
                                 max_workers=1)
    assert [json.dumps(p.to_dict()) for p in proofs] == \
        [host_proof_json(c, w) for c, w in zip(circuits[:3], ws[:3])]


def test_prove_auto_routes_a_card_backend_to_prove_pipelined(monkeypatch):
    """prove_pipelined for a TorchBackend on a CUDA device when a layer is
    wider than its host threshold; prove() otherwise; no backend means the
    card, which raises here; a failure of the route propagates."""
    calls = []
    monkeypatch.setattr(A, "prove_pipelined", lambda c, w, backend: calls.append("pipe"))
    monkeypatch.setattr(A, "prove", lambda c, w, backend: calls.append("prove"))
    circuits, ws, _ = compiled(F, width_limit=1)
    circuit, w = circuits[0], ws[0]
    top = max(l.k_next for l in circuit.layers)
    card = port.TorchBackend(device="cpu", host_threshold=top - 1)
    card.device = torch.device("cuda")      # routing only; nothing runs on it
    A._prove_auto(circuit, w, card)
    card.host_threshold = top
    A._prove_auto(circuit, w, card)
    A._prove_auto(circuit, w, port.TorchBackend(device="cpu", host_threshold=0))
    A._prove_auto(circuit, w, port.HostBackend())
    assert calls == ["pipe", "prove", "prove", "prove"]

    def missing(*a, **kw):
        raise ImportError("no engine")
    monkeypatch.setattr(A, "prove_pipelined", missing)
    card.host_threshold = 0
    with pytest.raises(ImportError):
        A._prove_auto(circuit, w, card)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A._prove_auto(circuit, w, None)


def test_kernel_library_loads_once_under_threads(monkeypatch):
    """The aggregator's threads share one kernel library: however many reach
    its first use at once, one builds and loads it."""
    import threading
    from gkr_tpu_torch.torcheng import kernels as K

    loads = []

    def load_library():
        loads.append(1)
        time.sleep(0.01)
        return object()

    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "_load_library", load_library)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=K._load) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and K._lib is not None


# --------------------------------------------------------------------- CLI

def test_cli_has_the_five_subcommands():
    with pytest.raises(SystemExit) as ex:
        run_cli(cli.main, ["--help"])
    assert ex.value.code == 0
    parser_help = io.StringIO()
    with contextlib.redirect_stdout(parser_help), pytest.raises(SystemExit):
        cli.main(["prove-r1cs", "--help"])
    assert "{torch,host,sharded,cpp}" in parser_help.getvalue()
    for cmd in ("prove", "mock-groth", "prove-r1cs", "verify", "prove-native"):
        with contextlib.redirect_stdout(io.StringIO()), pytest.raises(SystemExit) as ex:
            cli.main([cmd, "--help"])
        assert ex.value.code == 0


def test_cli_prove_r1cs_and_verify_match_gkr_tpu(tmp_path):
    """`python -m gkr_tpu_torch prove-r1cs --backend host` (2 processes)
    writes gkr_tpu's proofs.json byte for byte; `verify` accepts every
    subcircuit, and fails subcircuit 0 with exit code 1 once one field
    element is flipped."""
    out, ref = tmp_path / "proofs.json", tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "gkr_tpu_torch", "prove-r1cs",
                          "--r1cs", R1CS, "--wtns", WTNS, "--sym", SYM,
                          "--backend", "host", "--workers", "2", "-o", str(out)],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rc, _ = run_cli(jax_cli.main, ["prove-r1cs", "--r1cs", R1CS, "--wtns", WTNS,
                                   "--sym", SYM, "-o", str(ref)])
    assert rc == 0
    assert out.read_bytes() == ref.read_bytes()

    rc, text = run_cli(cli.main, ["verify", "--proof", str(out), "--r1cs", R1CS,
                                  "--wtns", WTNS])
    lines = text.splitlines()
    assert rc == 0 and len(lines) == 12 and all(l.endswith(": OK") for l in lines)

    data = json.loads(out.read_text())
    rnd = data["proofs"][0]["sumcheckProof"][0][0]
    rnd[0] = str((int(rnd[0]) + 1) % P)
    bad = tmp_path / "flipped.json"
    bad.write_text(json.dumps(data))
    rc, text = run_cli(cli.main, ["verify", "--proof", str(bad), "--r1cs", R1CS,
                                  "--wtns", WTNS])
    assert rc == 1
    assert text.splitlines()[0] == "subcircuit 0: FAIL"


def test_cli_prove_r1cs_cpp_matches_gkr_tpu_cpp(tmp_path):
    """`python -m gkr_tpu_torch prove-r1cs --backend cpp` (8 threads, a
    CppBackend each) writes the bytes of `python -m gkr_tpu prove-r1cs
    --backend cpp`, and both packages' `verify` exit 0 on them."""
    out, ref = tmp_path / "proofs.json", tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "gkr_tpu_torch", "prove-r1cs",
                          "--r1cs", R1CS, "--wtns", WTNS, "--sym", SYM,
                          "--backend", "cpp", "-o", str(out)],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rc, _ = run_cli(jax_cli.main, ["prove-r1cs", "--r1cs", R1CS, "--wtns", WTNS,
                                   "--sym", SYM, "--backend", "cpp", "-o", str(ref)])
    assert rc == 0
    assert out.read_bytes() == ref.read_bytes()
    for main in (cli.main, jax_cli.main):
        rc, text = run_cli(main, ["verify", "--proof", str(out), "--r1cs", R1CS,
                                  "--wtns", WTNS])
        lines = text.splitlines()
        assert rc == 0 and len(lines) == 12 and all(l.endswith(": OK") for l in lines)


def test_cli_proves_on_the_card_one_subcircuit_after_another(monkeypatch):
    """--backend torch takes one backend and no pool unless --workers asks
    for threads; --backend host takes one HostBackend and 8 processes."""
    monkeypatch.setattr(cli, "_backend_factory", lambda args: lambda: args.backend)
    def args(backend, workers):
        return argparse.Namespace(backend=backend, workers=workers)

    assert cli._backend_args(args("torch", None)) == {"backend": "torch", "max_workers": 1}
    assert cli._backend_args(args("torch", 1)) == {"backend": "torch", "max_workers": 1}
    threads = cli._backend_args(args("torch", 4))
    assert threads["max_workers"] == 4 and threads["backend_factory"]() == "torch"
    assert cli._backend_args(args("host", None)) == {"backend": "host", "max_workers": 8}
    assert cli._backend_args(args("host", 2)) == {"backend": "host", "max_workers": 2}
    cpp = cli._backend_args(args("cpp", None))      # the reference's threads
    assert cpp["max_workers"] == 8 and cpp["backend_factory"]() == "cpp"
    assert cli._backend_args(args("cpp", 1)) == {"backend": "cpp", "max_workers": 1}


def test_cli_backend_torch_without_a_card_fails(tmp_path):
    """--backend torch (the default) means the card: without one the command
    raises (so `python -m gkr_tpu_torch` exits non-zero) and writes nothing;
    there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --backend torch would prove on it")
    out = tmp_path / "proofs.json"
    for extra in ([], ["--backend", "torch", "--workers", "4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli(cli.main, ["prove-r1cs", "--r1cs", R1CS, "--wtns", WTNS,
                               "-o", str(out), *extra])
    assert not out.exists()
