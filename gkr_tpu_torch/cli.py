"""gkr_tpu_torch command-line interface: python -m gkr_tpu_torch.

Reference-parity commands (rust/src/bin.rs):
  prove       -c <circuit.circom> -i <input1.json> [input2.json ...]
  mock-groth  -z <zkey>

Extensions:
  prove-r1cs    direct GKR proving from .r1cs + .wtns (no toolchain)
  verify        host verification of a proof JSON against .r1cs + .wtns
  prove-native  circom-free recursive aggregation of a built-in example

--backend torch (the default) proves on the CUDA card and fails without
one; --backend sharded proves each layer sumcheck over D shards
(`parallel.ShardedBackend`: every visible card, or --devices N shards taking
the cards in turn; --device cpu puts the shards on the CPU instead);
--backend host proves with the exact host engine (Python ints);
--backend cpp with the native host engine (`native.CppBackend`: the layer
sumcheck in C++ and OpenMP, built by g++ at first use), one backend a
thread, 8 threads by default.
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial


BACKENDS = ("torch", "host", "sharded", "cpp")
WORKERS_HELP = ("subcircuit prove parallelism: threads on the card (default "
                "1), host processes (--backend host, default 8) or host "
                "threads (--backend cpp, default 8; 1: one shared backend); "
                "the reference's rayon par_iter analog")
DEVICE_HELP = ("--backend sharded: where the shards prove, cuda (the default: "
               "every visible card; fails without one) or cpu")
DEVICES_HELP = ("--backend sharded: the number of shards D, a power of two "
                "(default: one a visible card; fewer cards are taken in turn)")


def _add_backend_args(p, workers: bool = True) -> None:
    """--backend, --device and --devices (the latter two for --backend
    sharded alone, checked in `main`), and --workers where `workers`."""
    p.add_argument("--backend", default="torch", choices=BACKENDS)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help=DEVICE_HELP)
    p.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    if workers:
        p.add_argument("--workers", type=int, default=None, help=WORKERS_HELP)


def _backend_factory(args):
    """A zero-arg constructor for --backend: TorchBackend (the card),
    ShardedBackend over `make_mesh` on --device (its D and devices printed
    once, to stderr), the native CppBackend or the pure-Python
    HostBackend."""
    if args.backend == "torch":
        from .torcheng.backend import TorchBackend
        return TorchBackend
    if args.backend == "sharded":
        from .parallel.sharding import ShardedBackend, distinct, make_mesh
        mesh = make_mesh(args.devices, devices=[args.device]
                         if args.device == "cpu" else None)
        print(f"sharded backend: D = {len(mesh)} shards on "
              + ", ".join(str(d) for d in distinct(mesh)), file=sys.stderr)
        return partial(ShardedBackend, mesh)
    if args.backend == "cpp":
        from .native.engine import CppBackend
        return CppBackend
    from .prover import HostBackend
    return HostBackend


def _backend_args(args) -> dict:
    """Map --backend/--workers onto prove_subcircuits' pool contract
    (recursion/aggregator.py).  --backend torch and sharded prove the
    subcircuits one after another on the card by default: threads sharing
    one card and its stream were about 2x slower than one (PERF.md §7);
    --workers N > 1 gives each of N threads its own backend through a
    backend_factory.  --backend host passes one HostBackend, which takes
    the spawn process pool inside prove_subcircuits, 8 workers by default
    (the reference's rayon par_iter, aggregator.rs:411-416).  --backend cpp
    is the reference's: 8 threads by default, each with its own
    CppBackend, and --workers 1 one shared backend."""
    factory = _backend_factory(args)
    if args.backend == "host":
        return {"backend": factory(), "max_workers": args.workers or 8}
    workers = args.workers or (8 if args.backend == "cpp" else 1)
    if workers <= 1:
        return {"backend": factory(), "max_workers": 1}
    return {"backend_factory": factory, "max_workers": workers}


def cmd_prove(args) -> int:
    from .recursion.aggregator import prove_all
    prove_all(args.circuit, args.inputs, strong=args.strong_circom,
              **_backend_args(args))
    return 0


def cmd_mock_groth(args) -> int:
    from .recursion.circom_driver import mock_groth
    print("mock groth16 running..")
    mock_groth(args.zkey)
    return 0


def cmd_prove_r1cs(args) -> int:
    from .frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr, parse_sym
    r1cs = R1csFile.read(args.r1cs)
    wtns = WtnsFile.read(args.wtns)
    sym_names = None
    n_public = r1cs.header.n_pub_out + r1cs.header.n_pub_in
    if args.sym:
        sym_names = parse_sym(args.sym, n_public)
    circuits, w_values, public = compile_r1cs_to_gkr(r1cs, wtns, sym_names)
    from .recursion.aggregator import prove_subcircuits
    proofs = [p.to_dict() for p in prove_subcircuits(
        circuits, w_values, check_verify=False, **_backend_args(args))]
    out = {"proofs": proofs,
           "public": {name: str(v) for name, v in public.values()}}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
        print(f"{len(proofs)} subcircuit proof(s) written to {args.output}")
    else:
        json.dump(out, sys.stdout)
    return 0


def cmd_verify(args) -> int:
    from .frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr
    from .proof import Proof
    from .verifier import verify
    with open(args.proof) as f:
        data = json.load(f)
    proofs = [Proof.from_dict(d) for d in data["proofs"]]
    circuits = None
    if args.r1cs and args.wtns:
        r1cs = R1csFile.read(args.r1cs)
        wtns = WtnsFile.read(args.wtns)
        circuits, _, _ = compile_r1cs_to_gkr(r1cs, wtns)
        if len(circuits) != len(proofs):
            print("subcircuit count mismatch", file=sys.stderr)
            return 1
    ok = True
    for i, proof in enumerate(proofs):
        circuit = circuits[i] if circuits else None
        good = verify(proof, circuit)
        print(f"subcircuit {i}: {'OK' if good else 'FAIL'}")
        ok &= good
    return 0 if ok else 1


def cmd_prove_native(args) -> int:
    from .examples import mimc_example, square_chain_example
    from .recursion.native import prove_all_native
    fn = {"mimc": mimc_example, "square": square_chain_example}[args.example]
    inputs = []
    for path in args.inputs:
        with open(path) as f:
            inputs.append(json.load(f))
    proofs = prove_all_native(fn, inputs,
                              backend=_backend_factory(args)(),
                              export_final=args.export,
                              full_fs=not args.weak_gadget,
                              recombination=not args.weak_gadget)
    print(f"native aggregation complete: {len(proofs)} final subcircuit "
          f"proof(s) over {len(inputs)} inputs")
    if args.export:
        print(f"final round exported to {args.export}.r1cs / "
              f"{args.export}.wtns (groth16 via: snarkjs)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gkr_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove", help="circom aggregation flow")
    p.add_argument("-c", "--circuit", required=True)
    p.add_argument("-i", "--inputs", nargs="+", required=True)
    _add_backend_args(p)
    p.add_argument("--strong-circom", action="store_true",
                   help="embed the Fiat-Shamir-strengthened "
                        "VerifyGKRStrongFS gadget (gkr_verifier_fs.circom: "
                        "in-circuit MiMC7 challenge recomputation + z-chain "
                        "+ z_0=0 binding) instead of the reference-shaped "
                        "VerifyGKR with free challenge inputs")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("mock-groth", help="snarkjs groth16 hand-off")
    p.add_argument("-z", "--zkey", required=True)
    p.set_defaults(fn=cmd_mock_groth)

    p = sub.add_parser("prove-r1cs", help="direct proving from r1cs+wtns")
    p.add_argument("--r1cs", required=True)
    p.add_argument("--wtns", required=True)
    p.add_argument("--sym")
    p.add_argument("-o", "--output")
    _add_backend_args(p)
    p.set_defaults(fn=cmd_prove_r1cs)

    p = sub.add_parser("verify", help="verify proof JSON")
    p.add_argument("--proof", required=True)
    p.add_argument("--r1cs")
    p.add_argument("--wtns")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("prove-native", help="circom-free aggregation")
    p.add_argument("--example", default="mimc", choices=["mimc", "square"])
    p.add_argument("-i", "--inputs", nargs="+", required=True)
    p.add_argument("--export", default=None)
    _add_backend_args(p, workers=False)
    p.add_argument("--weak-gadget", action="store_true",
                   help="embed the reference-parity WEAK verifier gadget "
                        "(free Fiat-Shamir inputs, no wiring recombination "
                        "- verifier.circom:22-29) instead of the default "
                        "full-strength gadget; ~100x smaller rounds, the "
                        "soundness of the recursion then rests on the final "
                        "round's host verification only")
    p.set_defaults(fn=cmd_prove_native)

    args = ap.parse_args(argv)
    if (getattr(args, "backend", "sharded") != "sharded"
            and (args.device is not None or args.devices is not None)):
        ap.error("--device and --devices are options of --backend sharded")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
