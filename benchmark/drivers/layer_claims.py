"""Traffic of layer claims: the fused layer sumcheck of one wide layer,
claim after claim, by one client in a closed loop.

Each batch of `batch` claims (a fresh point z each, from the seed) is
dispatched with `defer=True`, as the program's pipelined prover does, then
downloaded at once, then each claim passes the program's host check
(`finish`).  The witness stays on the card and the layer's wiring plan is
built once in set-up.  A claim's latency runs from its batch's dispatch to
the end of its host check.

Traffic keys: "batch", "check_sample" (claims the reference re-proves,
one from each slot of a batch in turn).
"""

from __future__ import annotations

import time

from ..generators.common import elements, gate_tuples, rng
from ..harness import Request


class Driver:
    kind = "layer_claims"

    def __init__(self, cfg: dict, traffic: dict, generator, seed: int,
                 device: str, spans):
        self.cfg, self.traffic, self.gen = cfg, traffic, generator
        self.seed, self.device, self.spans = seed, device, spans
        self.batch = int(traffic["batch"])
        self.requests: list[Request] = []

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from gkr_tpu_torch.mimc import Mimc7
        from gkr_tpu_torch.mle import MleStruct
        from gkr_tpu_torch.torcheng import fused as F
        from gkr_tpu_torch.torcheng import limbs as L

        self.F = F
        inst = self.gen.layer(self.cfg, rng(self.seed, 0))
        self.inst = inst
        k, kc = inst["k_next"], inst["k_cur"]
        self.add, self.mult = gate_tuples(inst["add"]), gate_tuples(inst["mult"])
        n = 1 << k
        self.shape = {"n": n, "gates": len(self.add) + len(self.mult),
                      "k_cur": kc}
        self.struct = MleStruct(k, False, [True] * k, k)   # full support
        self.transcript = Mimc7()
        self.w_dev = L.pack(inst["w"], self.device)
        self.wiring = F.build_wiring(self.add, self.mult, n, self.device)
        self.z_stream = rng(self.seed, 1)
        warm = rng(self.seed, 2)
        self._batch([elements(warm, kc) for _ in range(self.batch)], record=False)
        self._sync()

    def _sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def _claim(self, z):
        inst = self.inst
        return self.F.prove_layer_sumcheck_fused(
            z, inst["w"], self.add, self.mult, inst["k_cur"], inst["k_next"],
            self.struct, self.transcript, w_dev=self.w_dev, wiring=self.wiring,
            defer=True, device=self.device)

    def _batch(self, zs, record=True):
        t0 = time.perf_counter()
        reqs = [Request(t0, gates=self.shape["gates"], point=z) for z in zs]
        try:
            with self.spans.marker("dispatch"):
                outs = [self._claim(z) for z in zs]
            with self.spans.marker("download"):
                host = self.F.download([a for arrays, _ in outs for a in arrays])
        except Exception as exc:          # a request that raises has failed
            for r in reqs:
                r.fail(exc)
        else:
            for i, (arrays, finish) in enumerate(outs):
                self.spans.request = len(self.requests) + i
                part = host[len(arrays) * i:len(arrays) * (i + 1)]
                try:
                    with self.spans.span("host_check"):
                        reqs[i].answer = finish(part)
                except Exception as exc:  # a request that raises has failed
                    reqs[i].fail(exc)
                reqs[i].end = time.perf_counter()
        if record:
            self.requests += reqs

    # -- the window ------------------------------------------------------------

    def window(self, deadline: float) -> None:
        """Batches until `deadline` (host clock); the batch started last
        runs to its end."""
        kc = self.inst["k_cur"]
        while time.perf_counter() < deadline:
            self._batch([elements(self.z_stream, kc) for _ in range(self.batch)])

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        self.w_dev = self.wiring = None

    # -- the comparison --------------------------------------------------------

    def check(self, reference, sample, control=None) -> dict:
        """Re-prove `sample` (indices into the window's claims) with the
        reference: (compared elements, mismatched elements).  With a
        `control` (a reference of lower strength), its answers are judged
        in the program's place."""
        from ..reference.compare import layer_mismatches

        inst = self.inst
        W = reference.f.encode(inst["w"])
        empty, sup, _ = reference.structure(reference.mobius(W))
        if empty:
            sup = [False] * inst["k_next"]
        compared = mismatched = 0
        for i in sample:
            req = self.requests[i]
            want = reference.layer(req.point, W, inst["add"], inst["mult"], sup)
            got = req.answer
            if control is not None:
                ctl = control.layer(req.point, W, inst["add"], inst["mult"], sup)
                got = (ctl["proof"], ctl["r"])
            c, m = layer_mismatches(got, want)
            compared += c
            mismatched += m
        return {"compared": compared, "mismatched": mismatched}

    def sample(self, g, count: int) -> list[int]:
        """`count` answered claims drawn with g, the slots of a batch taken
        in turn (claim i sits at slot i mod batch of its batch's dispatch
        and download), so that `count` >= `batch` covers every slot."""
        pools = [[i for i in range(slot, len(self.requests), self.batch)
                  if self.requests[i].ok] for slot in range(self.batch)]
        out = []
        while len(out) < count and any(pools):
            for pool in pools:
                if pool and len(out) < count:
                    out.append(pool.pop(int(g.integers(len(pool)))))
        return sorted(out)
