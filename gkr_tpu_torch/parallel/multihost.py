"""Several controllers proving together: H processes, one mesh.

The port's twin of the JAX package's `scripts/run_multihost.py`.  The
parent spawns H ranks as `python -m gkr_tpu_torch.parallel.multihost
--child ...` subprocesses; each joins one `torch.distributed` default
group (a `file://` store in a temporary directory, so runs side by side
never meet), builds `make_mesh(hosts=H, devices=[its device] * d_local)`
and runs a list of jobs on it, the same on every rank, as the JAX
script's children run `ShardedSumcheck` over a (2, 4) ("dcn", "ici")
mesh.  The children import the port and torch only.

  * On the card the parent builds the kernels once before it spawns, so
    no two ranks run `nvcc`.
  * The backend defaults to NCCL where the ranks' cards are distinct and
    to gloo otherwise (on one card both ranks use cuda:0: NCCL refuses two
    ranks on one GPU); the choice is printed, never taken after a failure.
  * Each rank's group has a timeout, the parent waits with one and kills
    children that outlive it; any child's failure makes the parent raise
    with every child's output.

The default job is the JAX script's: its `synth(k)` layer (k = 8) over 2
ranks x 4 shards, proved twice; rank 0 holds the transcript to the port's
host engine and prints the script's JSON keys.  Nothing is written into
the repository.

Usage:
    python -m gkr_tpu_torch.parallel.multihost [k] [--device cuda|cpu]
        [--d-local N] [--backend gloo|nccl] [--timeout S]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import random
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from ..circuit import synth_circuit
from ..field import P
from ..mimc import Mimc7
from ..mle import MleStruct, mle_struct
from ..prover import prove
from ..sumcheck import prove_layer_sumcheck
from ..torcheng import kernels as K
from . import sharding as S

HOSTS = 2
D_LOCAL = 4
# The ranks' working directory: it holds gkr_tpu_torch/, so `python -m` finds it
ROOT = Path(__file__).resolve().parent.parent.parent


# --------------------------------------------------------------- the inputs

def synth(k: int, k_cur: int = 4):
    """`scripts/run_multihost.py`'s layer: 2^k gates over a 2^k-entry
    next layer, odd gates add and even mult, outputs g mod 2^k_cur, drawn
    from random.Random(1) -> (z, w, add, mult, k_cur, struct)."""
    rng = random.Random(1)
    n = 1 << k
    w = [rng.randrange(P) for _ in range(n)]
    add_gates, mult_gates = [], []
    for g in range(n):
        o = g & ((1 << k_cur) - 1)
        trip = (o, rng.randrange(n), rng.randrange(n))
        (add_gates if g & 1 else mult_gates).append(trip)
    z = [rng.randrange(P) for _ in range(k_cur)]
    struct = MleStruct(k, False, [True] * k, k)
    return z, w, add_gates, mult_gates, k_cur, struct


def hot_layer(k_cur: int, k_next: int, hot: int, left: int, seed: int):
    """A layer with a hot bucket: `hot` add gates (outputs g mod 2^k_cur)
    on left input `left`, random right inputs, then one random mult gate
    for each output from `hot` to 2^k_cur; W and the point z at random,
    full-size field elements -> (z, w, add, mult)."""
    rng = np.random.default_rng(seed)
    n_out = 1 << k_cur
    lr = rng.integers(0, 1 << k_next, size=(max(hot, n_out), 2)).tolist()
    add = [(g % n_out, left, lr[g][1]) for g in range(hot)]
    mult = [(o, *lr[o]) for o in range(hot, n_out)]

    def field():
        return int.from_bytes(rng.bytes(32), "little") % P

    w = [field() for _ in range(1 << k_next)]
    z = [field() for _ in range(k_cur)]
    return z, w, add, mult


def proof_digest(proof) -> str:
    return hashlib.sha256(json.dumps(proof.to_dict()).encode()).hexdigest()


# ------------------------------------------------------------------ the jobs

def _counts():
    return {"launches": {k: v for k, v in K.LAUNCHES.items() if v},
            "collectives": dict(S.COLLECTIVES),
            "collective_bytes": dict(S.COLLECTIVE_BYTES)}


def _reset():
    K.reset_launches()
    S.reset_collectives()


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def job_layer(mesh, device: str, k: int = 8, k_cur: int = 4, reps: int = 2,
              check_host: bool = False, tamper_round: int = 0) -> dict:
    """`synth(k, k_cur)`'s layer sumcheck over the mesh, `reps` times
    (counts of the first): its transcript, launches, collectives and
    times.  `check_host`: rank 0 holds it to the port's host engine.
    `tamper_round` > 0: the last rank's device challenge of that round is
    corrupted; the RuntimeError every rank must raise is returned."""
    z, w, ag, mg, kc, struct = synth(k, k_cur)
    eng = S.ShardedSumcheck(mesh)
    if tamper_round:
        real, calls = K.round_tail, []

        def corrupt(partials, length):
            co, r = real(partials, length)
            calls.append(r)
            if mesh.rank == mesh.hosts - 1 and len(calls) == tamper_round:
                r = r.clone()
                r[0] ^= 1
            return co, r

        K.round_tail = corrupt
        try:
            eng.prove_layer_sumcheck(z, w, ag, mg, kc, k, struct, Mimc7())
        except RuntimeError as e:
            return {"raised": str(e)}
        finally:
            K.round_tail = real
        return {"raised": None}
    seconds = []
    for rep in range(reps):
        _reset()
        t0 = time.perf_counter()
        proof, challenges = eng.prove_layer_sumcheck(z, w, ag, mg, kc, k, struct,
                                                     Mimc7())
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        if rep == 0:
            counts = _counts()
    out = {"proof": proof, "challenges": challenges, "seconds": seconds, **counts}
    if check_host and mesh.rank == 0:
        want = prove_layer_sumcheck(z, w, ag, mg, kc, k, struct, Mimc7())
        out["transcript_matches_host_engine"] = (proof, challenges) == tuple(want)
    return out


def job_hot(mesh, device: str, k_cur: int, k_next: int, hot: int,
            seed: int = 12) -> dict:
    """`hot_layer`'s sumcheck over the mesh with the hot bucket's left
    input the last rank's first global shard (so its segment sum runs on
    that rank): its transcript, launches, collectives and, for each local
    shard, the add gates of its phase-1 row 0 (the hot bucket's row)."""
    left = mesh.D - mesh.D // mesh.hosts
    z, w, add, mult = hot_layer(k_cur, k_next, hot, left, seed)
    eng = S.ShardedSumcheck(mesh)
    _reset()
    proof, challenges = eng.prove_layer_sumcheck(
        z, w, add, mult, k_cur, k_next, mle_struct(w), Mimc7(), layer_idx=0)
    row0 = [0 if p.a1 is None else int(p.a1.hib[0]) for p in eng._plans[0][3]]
    return {"left": left, "row0_add_gates": row0, "proof": proof,
            "challenges": challenges, **_counts()}


def job_prove(mesh, device: str, k: int, k_input: int, seed: int = 7,
              host_threshold: int = 10, reps: int = 2, want: str | None = None,
              with_proof: bool = False, proof_out: str | None = None) -> dict:
    """`synth_circuit(k, k_input, seed)` proved through
    `ShardedBackend(mesh)`, `reps` times (plans built, then cached;
    launches and collectives of the first): the proof's digest, equal on
    every rep and to `want` where given (else AssertionError), and the
    seconds of each.  Rank 0 writes the proof's JSON to `proof_out`."""
    circuit, inputs = synth_circuit(k, k_input, seed)
    w = circuit.evaluate(inputs)
    backend = S.ShardedBackend(mesh, host_threshold=host_threshold)
    seconds, digests = [], []
    for rep in range(reps):
        _reset()
        t0 = time.perf_counter()
        proof = prove(circuit, w, backend=backend)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        digests.append(proof_digest(proof))
        if rep == 0:
            counts = _counts()
    if len(set(digests)) != 1 or (want is not None and digests[0] != want):
        raise AssertionError(f"rank {mesh.rank}: proof digests {digests}, "
                             f"expected {want}")
    if proof_out and mesh.rank == 0:
        proof.to_json(proof_out)
    out = {"digest": digests[0], "seconds": seconds, **counts}
    if with_proof:
        out["proof"] = proof.to_dict()
    return out


JOBS = {"layer": job_layer, "hot": job_hot, "prove": job_prove}


# ------------------------------------------------------------------ the ranks

def rank_devices(hosts: int, device: str) -> list[str]:
    """Each rank's device: the CPU, or card r mod the visible cards."""
    if device == "cpu":
        return ["cpu"] * hosts
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: no CUDA device (pass device='cpu' to run "
                           "the ranks on the CPU)")
    return [f"cuda:{r % torch.cuda.device_count()}" for r in range(hosts)]


def default_backend(devices: list[str]) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise."""
    cards = [d for d in devices if d.startswith("cuda")]
    return "nccl" if len(cards) == len(devices) == len(set(cards)) else "gloo"


def spawn(jobs, hosts: int = HOSTS, d_local: int = D_LOCAL, device: str = "cuda",
          backend: str | None = None, threads: int | None = None,
          timeout: float = 600.0, log=print) -> list[list[dict]]:
    """Run `jobs`, a list of (name in JOBS, keyword arguments), on `hosts`
    ranks, each job over `make_mesh(hosts=hosts, devices=[rank's device] *
    d_local)` unless its arguments give another `d_local` -> each rank's
    results, job by job.  Raises RuntimeError with every rank's output if a
    rank fails or outlives `timeout` seconds (it is then killed)."""
    devices = rank_devices(hosts, device)
    chosen = backend or default_backend(devices)
    why = "" if backend else (" (the default: a card a rank)" if chosen == "nccl"
                              else " (the default: the ranks have no card each)")
    log(f"multihost: {hosts} ranks on {', '.join(devices)}, {d_local} shards "
        f"each, backend {chosen}{why}")
    if device != "cpu":
        K.build()
    with tempfile.TemporaryDirectory(prefix="gkr_multihost_") as tmp, \
            contextlib.ExitStack() as stack:
        spec = Path(tmp, "jobs.json")
        spec.write_text(json.dumps(jobs))
        procs, logs = [], []
        for r in range(hosts):
            logs.append(stack.enter_context(open(Path(tmp, f"rank{r}.log"), "w+")))
            cmd = [sys.executable, "-m", "gkr_tpu_torch.parallel.multihost", "--child",
                   "--rank", str(r), "--hosts", str(hosts), "--rank-device", devices[r],
                   "--d-local", str(d_local), "--backend", chosen,
                   "--store", str(Path(tmp, "store")), "--jobs", str(spec),
                   "--out", str(Path(tmp, f"rank{r}.json")),
                   "--timeout", str(timeout)]
            if threads:
                cmd += ["--threads", str(threads)]
            procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        if timed_out or any(rcs):
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
            report = "\n".join(f"--- rank {r} (rc {rc}) ---\n{o}"
                               for r, (rc, o) in enumerate(zip(rcs, outs)))
            raise RuntimeError((f"multihost: ranks outlived {timeout:.0f} s"
                                if timed_out else "multihost: a rank failed")
                               + f"\n{report}")
        return [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(hosts)]


def child(args) -> int:
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.backend == "nccl":
        torch.cuda.set_device(args.rank_device)
    torch.distributed.init_process_group(
        args.backend, init_method=f"file://{args.store}", world_size=args.hosts,
        rank=args.rank, timeout=timedelta(seconds=args.timeout))
    try:
        results = []
        for name, kw in json.loads(Path(args.jobs).read_text()):
            kw = dict(kw)
            d_local = kw.pop("d_local", args.d_local)
            mesh = S.make_mesh(hosts=args.hosts, devices=[args.rank_device] * d_local)
            out = JOBS[name](mesh, args.rank_device, **kw)
            out["d_local"], out["D"] = d_local, mesh.D
            results.append(out)
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "gkr_tpu"))
        for out in results:
            out["foreign_modules"] = foreign
        Path(args.out).write_text(json.dumps(results))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gkr_tpu_torch.parallel.multihost")
    p.add_argument("k", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--d-local", type=int, default=D_LOCAL, help="shards a rank")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="default: nccl where every rank has a card of its own, "
                        "else gloo")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds the ranks may take")
    # a rank's arguments, given by `spawn`
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--hosts", type=int, default=HOSTS, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--rank-device", help=argparse.SUPPRESS)
    p.add_argument("--threads", type=int, help=argparse.SUPPRESS)
    for name in ("--store", "--jobs", "--out"):
        p.add_argument(name, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args)
    ranks = spawn([("layer", {"k": args.k, "reps": 2, "check_host": True})],
                  d_local=args.d_local, device=args.device, backend=args.backend,
                  timeout=args.timeout, log=lambda s: print(s, file=sys.stderr))
    res = [r[0] for r in ranks]
    same = all((r["proof"], r["challenges"]) == (res[0]["proof"], res[0]["challenges"])
               for r in res)
    ok = same and res[0]["transcript_matches_host_engine"]
    print(json.dumps({
        "ok": ok,
        "wall_ms": round(res[0]["seconds"][-1] * 1000, 1),
        "first_run_s": round(res[0]["seconds"][0], 1),
        "hosts": HOSTS,
        "devices_per_host": args.d_local,
        "mesh": f"{HOSTS} ranks x {args.d_local} shards (multi-controller, "
                f"torch.distributed) on {args.device}",
        "global_gates": 1 << args.k,
        "transcript_matches_host_engine": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
