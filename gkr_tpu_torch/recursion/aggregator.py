"""Recursive aggregation round loop — circom-toolchain path.

Mirrors rust/src/aggregator.rs `prove_all` (:385-435):
  round 0:    compile+witness the user circuit with input_0, convert to GKR
              subcircuits, prove all of them;
  rounds 1..n-2: `prove_recursively_circom` (:316-363) — pad+serialize the
              previous proofs into aggregated.json, splice VerifyGKR
              instantiations into the user's .circom (aggregated.circom),
              recompile via circom, re-witness via node, convert, prove;
  round n-1:  `prove_groth` (:372-383) — templating + circom compile only;
              the groth16 proof itself is produced by `mock-groth`.

Per-round artifacts keep the reference's file conventions: aggregated.json,
aggregated.circom, witness.wtns, <input>_output.json.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

from ..frontend import R1csFile, WtnsFile, compile_r1cs_to_gkr, parse_sym
from ..prover import HostBackend, prove
from ..torcheng.backend import TorchBackend, prove_pipelined
from ..verifier import verify as verify_proof
from .circom_driver import execute_circom
from .serialize import (CircomInputProof, get_meta, modify_proof_for_circom,
                        write_aggregated_input)
from .templating import modify_circom_file, structural_lens

# The reference proves the <=20 subcircuits of a round with a rayon
# par_iter (rust/src/aggregator.rs:350-355,411-416).  Here each subcircuit
# is an independent transcript, so any pool is safe; the pool KIND matters:
#   * HostBackend (pure-Python big ints): the GIL serializes threads, so
#     real speedup needs a PROCESS pool (spawn workers, each importing
#     torch; amortized over large proofs and skipped below
#     PROCESS_MIN_GATES);
#   * per-thread backends via backend_factory (TorchBackend): the threads
#     share the card and its current stream; on an H100 4 threads took about
#     twice as long as 1 (PERF.md §7), so the CLI proves on the card one
#     subcircuit after another unless asked for more workers.  The port's
#     kernel launch counters (kernels.LAUNCHES, fused.DOWNLOADS) are exact
#     only with one thread.
MAX_PROVE_WORKERS = 8
PROCESS_MIN_GATES = 1 << 13     # total gates below which spawn cost loses


def _prove_subcircuit_task(args):
    """Module-level worker (picklable) for the process pool."""
    circuit, w_values, check = args
    proof = prove(circuit, w_values, backend=HostBackend())
    if check:
        assert verify_proof(proof, circuit), "self-verification failed"
    return proof


def _prove_auto(circuit, w_values, backend):
    """prove(), routed through the device-resident pipelined walk when the
    backend is a TorchBackend on a CUDA card AND the circuit has
    device-sized layers: prove_pipelined keeps the z-chain on the card and
    syncs twice per proof instead of once per layer (the deferred batching
    of fused.py defer=True threaded through the full layer walk).  No
    backend means prove()'s default, TorchBackend() on the card.  Every
    failure propagates."""
    if backend is None:
        backend = TorchBackend()
    if (isinstance(backend, TorchBackend) and backend.device.type == "cuda"
            and any(l.k_next > backend.host_threshold
                    for l in circuit.layers)):
        return prove_pipelined(circuit, w_values, backend=backend)
    return prove(circuit, w_values, backend=backend)


def prove_subcircuits(circuits, w_values_list, backend=None,
                      backend_factory=None, check_verify: bool = True,
                      max_workers: int = MAX_PROVE_WORKERS):
    """Prove all subcircuits of one aggregation round — the rayon par_iter
    analog (rust/src/aggregator.rs:350-355).  See MAX_PROVE_WORKERS note
    for the pool-kind rationale.  No backend means the card
    (TorchBackend()), one subcircuit after another; a HostBackend takes the
    spawn process pool above PROCESS_MIN_GATES.  The CLI reaches this
    parallelism via --backend/--workers (cli._backend_args builds a
    backend_factory for --backend torch --workers N > 1)."""

    def prove_one(idx: int):
        b = backend_factory() if backend_factory is not None else backend
        proof = _prove_auto(circuits[idx], w_values_list[idx], b)
        if check_verify:
            assert verify_proof(proof, circuits[idx]), \
                f"self-verification failed (subcircuit {idx})"
        return proof

    nsub = len(circuits)
    if nsub <= 1:
        return [prove_one(i) for i in range(nsub)]
    workers = min(max_workers, nsub)
    if backend_factory is not None:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(prove_one, range(nsub)))
    if not isinstance(backend, HostBackend):
        # the card (None: TorchBackend()) or one shared stateful backend
        # instance, not safe to share across threads; sequential (pass
        # backend_factory to parallelize)
        return [prove_one(i) for i in range(nsub)]
    total = sum(sum(layer.n_gates() for layer in c.layers)
                for c in circuits)
    if total < PROCESS_MIN_GATES:
        return [prove_one(i) for i in range(nsub)]
    # spawn, never fork: the parent may hold CUDA state.  A child imports
    # the package, which neither initialises CUDA nor builds a kernel at
    # import, and proves on the host.
    ctx = multiprocessing.get_context("spawn")
    tasks = [(circuits[i], w_values_list[i], check_verify)
             for i in range(nsub)]
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_prove_subcircuit_task, tasks))


def _phase(label: str, t0: float) -> float:
    """Coarse per-phase timer, keeping the reference's phase vocabulary
    (aggregator.rs:349-358 `report_elapsed`)."""
    now = time.time()
    print(f"[{label}] {now - t0:.3f} seconds")
    return now


def _convert_and_prove(name: str, root_path: str, input_name: str,
                       workdir: str, backend=None, check_verify: bool = True,
                       backend_factory=None,
                       max_workers: int = MAX_PROVE_WORKERS):
    t0 = time.time()
    r1cs = R1csFile.read(os.path.join(workdir, root_path, f"{name}.r1cs"))
    wtns = WtnsFile.read(os.path.join(workdir, "witness.wtns"))
    n_public = r1cs.header.n_pub_out + r1cs.header.n_pub_in
    sym_names = parse_sym(os.path.join(workdir, root_path, f"{name}.sym"),
                          n_public)
    circuits, w_values_list, public = compile_r1cs_to_gkr(r1cs, wtns,
                                                          sym_names)
    t0 = _phase("convert", t0)

    print("Proving starts..")
    proofs = prove_subcircuits(circuits, w_values_list, backend=backend,
                               backend_factory=backend_factory,
                               check_verify=check_verify,
                               max_workers=max_workers)
    t0 = _phase("prove", t0)

    out_path = os.path.join(workdir, root_path, f"{input_name}_output.json")
    with open(out_path, "w") as f:
        json.dump({nm: str(v) for nm, v in public.values()}, f)
    return proofs


def prove_recursively_circom(circuit_path: str, previous_proofs, input_path: str,
                             workdir: str = ".", backend=None,
                             check_verify: bool = True,
                             backend_factory=None,
                             max_workers: int = MAX_PROVE_WORKERS,
                             strong: bool = False):
    t0 = time.time()
    metas = get_meta(previous_proofs)
    # structural lengths from the UNPADDED proofs (strong mode: they pick
    # the coefficient suffix each in-circuit Fiat-Shamir hash consumes)
    lens = structural_lens(previous_proofs) if strong else None
    padded = modify_proof_for_circom(previous_proofs, metas)
    cips = [CircomInputProof(p) for p in padded]

    input_name = os.path.splitext(os.path.basename(input_path))[0]
    agg_input = write_aggregated_input(
        input_path, cips, os.path.join(workdir, "aggregated.json"))
    agg_circuit = modify_circom_file(
        circuit_path, metas, os.path.join(workdir, "aggregated.circom"),
        lens=lens)
    print(f"{agg_circuit} generated")
    t0 = _phase("serialize", t0)

    name, root_path = execute_circom(agg_circuit, agg_input, workdir)
    _phase("compile", t0)
    return _convert_and_prove(name, root_path, input_name, workdir, backend,
                              check_verify=check_verify,
                              backend_factory=backend_factory,
                              max_workers=max_workers)


def prove_groth(circuit_path: str, previous_proofs, input_path: str,
                workdir: str = ".", strong: bool = False):
    metas = get_meta(previous_proofs)
    lens = structural_lens(previous_proofs) if strong else None
    padded = modify_proof_for_circom(previous_proofs, metas)
    cips = [CircomInputProof(p) for p in padded]
    agg_input = write_aggregated_input(
        input_path, cips, os.path.join(workdir, "aggregated.json"))
    agg_circuit = modify_circom_file(
        circuit_path, metas, os.path.join(workdir, "aggregated.circom"),
        lens=lens)
    execute_circom(agg_circuit, agg_input, workdir)
    print("Proving by groth16 can be done")


def prove_all(circuit_path: str, input_paths: list[str],
              workdir: str = ".", backend=None, check_verify: bool = True,
              backend_factory=None, max_workers: int = MAX_PROVE_WORKERS,
              strong: bool = False):
    """The reference CLI's `prove` flow (aggregator.rs:385-435).  Unlike the
    reference, each round self-verifies its proofs by default (a bad proof
    would otherwise propagate silently into the next round's witness)."""
    proofs = None
    for i, input_path in enumerate(input_paths):
        if i == 0:
            name, root_path = execute_circom(circuit_path, input_path, workdir)
            input_name = os.path.splitext(os.path.basename(input_path))[0]
            proofs = _convert_and_prove(name, root_path, input_name,
                                        workdir, backend,
                                        check_verify=check_verify,
                                        backend_factory=backend_factory,
                                        max_workers=max_workers)
        elif i == len(input_paths) - 1:
            prove_groth(circuit_path, proofs, input_path, workdir,
                        strong=strong)
        else:
            proofs = prove_recursively_circom(circuit_path, proofs,
                                              input_path, workdir, backend,
                                              check_verify=check_verify,
                                              backend_factory=backend_factory,
                                              max_workers=max_workers,
                                              strong=strong)
    return proofs
