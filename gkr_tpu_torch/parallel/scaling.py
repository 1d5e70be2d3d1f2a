"""The sharded engine's strong scaling at a fixed global size.

The port's twin of the JAX package's `scripts/bench_scaling.py`: one
k-variable layer (`multihost.synth(k)`, the script's) proved by
`ShardedSumcheck` over D = 1, 2, 4, 8 shards, each D the best of `reps`
after a warm-up that builds its wiring plans (host clock and a
synchronize; W packed once, plans cached), and efficiency(D) =
t(1) / (D * t(D)).

Each row names the distinct cards it ran on and is marked `"shared":
true` where D exceeds them: its shards take turns on a card, so it
measures the engine's overhead, not scaling, and is left out of the
headline efficiency.  On one card every row with D > 1 is shared and
there is no headline (null).

The collective audit counts one layer's gathers and their bytes from the
engine's counters (`sharding.COLLECTIVES`), in place of the script's scan
of the compiled HLO, and holds them to the engine's rule: k - log2 D
round gathers of D (3, 16) sums and one tail gather of D one-row stacks a
phase.  The transcript must be the same at every D.  Nothing is written.

Usage:
    python -m gkr_tpu_torch.parallel.scaling [k] [reps] [D,D,...] [--device cpu]
        (defaults 16 3 1,2,4,8 on the card)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..mimc import Mimc7
from ..torcheng import limbs as L
from . import sharding as S
from .multihost import synth


def expected_collectives(k: int, D: int) -> tuple[dict, dict]:
    """One layer's gathers on the single controller, by kind, and their
    bytes: a round gathers D (3, 16) int32 sums; a phase's tail D one-row
    stacks of 4 (phase 1) and 3 (phase 2) tables."""
    ld = D.bit_length() - 1
    counts = {"round": 2 * (k - ld), "tail": 2, "digest": 0, "mesh": 0}
    nbytes = {"round": counts["round"] * D * 3 * 64, "tail": D * (4 + 3) * 64,
              "digest": 0, "mesh": 0}
    return counts, nbytes


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(k: int = 16, reps: int = 3, ds=(1, 2, 4, 8), device: str = "cuda",
        log=print) -> dict:
    z, w, ag, mg, kc, struct = synth(k)
    n = 1 << k
    results, audit, ref = {}, {}, None
    for D in ds:
        mesh = S.make_mesh(D, devices=["cpu"] if device == "cpu" else None)
        cards = S.distinct(mesh)
        eng = S.ShardedSumcheck(mesh)
        w_dev = L.pack(w, eng.lead)

        def one():
            out = eng.prove_layer_sumcheck(z, w, ag, mg, kc, k, struct, Mimc7(),
                                           w_dev=w_dev, layer_idx=0)
            _sync(eng.lead)
            return out

        t0 = time.perf_counter()
        S.reset_collectives()
        transcript = one()                                  # builds the plans
        warm_s = time.perf_counter() - t0
        got = (dict(S.COLLECTIVES), dict(S.COLLECTIVE_BYTES))
        if got != expected_collectives(k, D):
            raise AssertionError(f"D = {D}: collectives {got}, expected "
                                 f"{expected_collectives(k, D)}")
        audit[str(D)] = {"collectives": got[0], "bytes": got[1]}
        if ref is None:
            ref = transcript
        elif transcript != ref:
            raise AssertionError(f"the transcript at D = {D} differs from D = {ds[0]}'s")
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            one()
            dt = time.perf_counter() - t0
            best = dt if best is None or dt < best else best
        results[D] = (best, [str(c) for c in cards], D > len(cards))
        log(f"D={D} on {', '.join(results[D][1])}: {best * 1000:8.1f} ms "
            f"{n / best:14,.0f} gates/s (first {warm_s:.2f} s)"
            + ("  [shared]" if results[D][2] else ""))
    t1 = results[ds[0]][0] * ds[0]          # normalized if the sweep starts above 1
    headline = {str(D): round(t1 / (D * t), 3)
                for D, (t, _, shared) in results.items() if D > 1 and not shared}
    name = (torch.cuda.get_device_name(torch.device(device)) if device != "cpu"
            else "cpu")
    return {
        "metric": f"sharded_layer_sumcheck_strong_scaling_2e{k}",
        "platform": f"{device}: {name}, single controller, one process",
        "host_cpus": os.cpu_count(),
        "global_gates": n,
        "reps": reps,
        "rows": {str(D): {"wall_ms": round(t * 1000, 3), "cards": cards,
                          "speedup": round(t1 / t, 3),
                          "efficiency": round(t1 / (D * t), 3), "shared": shared}
                 for D, (t, cards, shared) in results.items()},
        "headline_efficiency": headline or None,
        "interpretation": (
            "Rows marked shared ran more shards than distinct cards: their "
            "shards take turns on a card, so they measure the engine's "
            "overhead and are no efficiency evidence." if not headline else
            "The headline holds the rows whose shards each had a card."),
        "collective_audit": audit,
        "transcript_identical_across_D": True,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gkr_tpu_torch.parallel.scaling")
    p.add_argument("k", nargs="?", type=int, default=16)
    p.add_argument("reps", nargs="?", type=int, default=3)
    p.add_argument("ds", nargs="?", default="1,2,4,8")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    out = run(args.k, args.reps, tuple(int(x) for x in args.ds.split(",")),
              args.device, log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
