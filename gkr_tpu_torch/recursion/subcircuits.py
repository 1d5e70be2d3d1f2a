"""Proving N subcircuits against the number of workers.

The port's twin of the JAX package's `scripts/bench_subcircuits.py` (the
reference proves a round's <= 20 subcircuits with a rayon par_iter,
rust/src/aggregator.rs:350-355).  The same `synth_subcircuit(seed, k)`
subcircuits are proved by `prove_subcircuits` at 1, 2, 4 and 8 workers
in two pools:

  * `torch`: threads on the card, each with its own `TorchBackend`, as the
    CLI builds them for `--backend torch --workers N`;
  * `host`: the exact `HostBackend` in spawn processes (the script's pool),
    against an in-process sequential baseline.

Every pool's proofs must be the same bytes.  One JSON line with the
script's keys (`PARALLEL_r04.json`'s) for the host pool, and the card's
under "torch"; nothing is written.  Measures only: no default changes.

Usage:
    python -m gkr_tpu_torch.recursion.subcircuits [n_sub] [k]
        [--workers 1,2,4,8] [--pools torch,host] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from functools import partial

import torch


def synth_subcircuit(seed: int, k: int):
    """The script's subcircuit: 4 outputs <- 2^k random add (odd) and mult
    (even) gates over 2^k inputs, from random.Random(seed) -> (circuit,
    its evaluated layers)."""
    from ..circuit import GateLayer, GKRCircuit
    from ..field import P

    rng = random.Random(seed)
    n = 1 << k
    l0 = GateLayer(2, k, add_gates=[(o, rng.randrange(n), rng.randrange(n))
                                    for o in range(4)])
    add, mult = [], []
    for g in range(n):
        trip = (g, rng.randrange(n), rng.randrange(n))
        (add if g & 1 else mult).append(trip)
    l1 = GateLayer(k, k, add_gates=add, mult_gates=mult)
    circuit = GKRCircuit(layers=[l0, l1], input_k=k)
    inputs = [rng.randrange(P) for _ in range(n)]
    return circuit, circuit.evaluate(inputs)


def torch_args(workers: int, device: str) -> dict:
    """prove_subcircuits' arguments for `--backend torch --workers N`, as
    `cli._backend_args` builds them (on `device`)."""
    if device == "cuda":
        from ..cli import _backend_args
        return _backend_args(argparse.Namespace(backend="torch", workers=workers,
                                                device=None, devices=None))
    from ..torcheng.backend import TorchBackend
    factory = partial(TorchBackend, device=device)
    if workers <= 1:
        return {"backend": factory(), "max_workers": 1}
    return {"backend_factory": factory, "max_workers": workers}


def run(n_sub: int = 8, k: int = 11, workers=(1, 2, 4, 8), pools=("torch", "host"),
        device: str = "cuda", log=print) -> dict:
    from ..prover import HostBackend, prove
    from .aggregator import prove_subcircuits

    pairs = [synth_subcircuit(s, k) for s in range(n_sub)]
    circuits = [c for c, _ in pairs]
    w_lists = [w for _, w in pairs]
    gates = sum(sum(layer.n_gates() for layer in c.layers) for c in circuits)
    want = None

    def timed(label, fn):
        nonlocal want
        t0 = time.perf_counter()
        proofs = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [json.dumps(p.to_dict()) for p in proofs]
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"{label}: the proofs differ from the first run's")
        log(f"{label}: {dt:.3f} s")
        return dt

    out = {"metric": f"subcircuit_prove_scaling_{n_sub}x2e{k}",
           "host_cpus": os.cpu_count(), "total_gates": gates}
    if "torch" in pools:
        walls = {w: timed(f"torch, {w} thread(s)", partial(
            prove_subcircuits, circuits, w_lists, **torch_args(w, device)))
            for w in workers}
        out["torch"] = {
            "pool": "threads, a TorchBackend each (--backend torch --workers N)",
            "device": torch.cuda.get_device_name(0) if device == "cuda" else device,
            "wall_s": {str(w): round(t, 3) for w, t in walls.items()},
            "speedup_vs_1": {str(w): round(walls[workers[0]] / t, 3)
                             for w, t in walls.items()}}
    if "host" in pools:
        t_seq = timed("host, sequential (in-process)",
                      lambda: [prove(c, w, backend=HostBackend())
                               for c, w in zip(circuits, w_lists)])
        walls = {w: timed(f"host, {w} process(es)", partial(
            prove_subcircuits, circuits, w_lists, backend=HostBackend(), max_workers=w))
            for w in workers}
        out.update({"pool": "process (spawn), prove_subcircuits",
                    "sequential_s": round(t_seq, 3),
                    "wall_s": {str(w): round(t, 3) for w, t in walls.items()},
                    "speedup_vs_sequential": {str(w): round(t_seq / t, 3)
                                              for w, t in walls.items()}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gkr_tpu_torch.recursion.subcircuits")
    p.add_argument("n_sub", nargs="?", type=int, default=8)
    p.add_argument("k", nargs="?", type=int, default=11)
    p.add_argument("--workers", default="1,2,4,8")
    p.add_argument("--pools", default="torch,host")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    out = run(args.n_sub, args.k, tuple(int(x) for x in args.workers.split(",")),
              tuple(args.pools.split(",")), args.device,
              log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
