"""Traffic of whole proofs: the program's pipelined prover over one
circuit, proof after proof, by one client in a closed loop.

`witnesses` witnesses of the circuit (each from its own seeded inputs)
take turns; each proof starts from a fresh random point z0 from the seed.
The backend keeps the circuit's wiring plans, which one warm proof in
set-up builds; nothing derived from a witness outlives its proof.  A
proof's latency runs from its call to its return, sparse forms included.

Traffic keys: "witnesses", "check_sample" (proofs the reference re-proves,
taken from as many witnesses as it allows).
"""

from __future__ import annotations

import time

from ..generators.common import elements, gate_tuples, rng
from ..harness import Request


class Driver:
    kind = "proofs"

    def __init__(self, cfg: dict, traffic: dict, generator, seed: int,
                 device: str, spans):
        self.cfg, self.traffic, self.gen = cfg, traffic, generator
        self.seed, self.device, self.spans = seed, device, spans
        self.requests: list[Request] = []

    def setup(self) -> None:
        from gkr_tpu_torch.circuit import GateLayer, GKRCircuit
        from gkr_tpu_torch.torcheng.backend import TorchBackend, prove_pipelined

        from ..spans import traced_backend

        self.prove = prove_pipelined
        circ = self.gen.circuit(self.cfg, rng(self.seed, 0))
        self.circ = circ
        self.circuit = GKRCircuit(
            layers=[GateLayer(kc, kn, gate_tuples(a), gate_tuples(m))
                    for kc, kn, a, m in circ["layers"]],
            input_k=circ["input_k"])
        self.shape = {"gates": sum(layer.n_gates() for layer in self.circuit.layers)}
        self.witnesses = [self.gen.witness(circ, rng(self.seed, 1, j))
                          for j in range(int(self.traffic["witnesses"]))]
        self.backend = (traced_backend(self.spans, device=self.device)
                        if self.spans.enabled else TorchBackend(device=self.device))
        self.z_stream = rng(self.seed, 2)
        self.k0 = self.circuit.k(0)
        self._proof(0, elements(rng(self.seed, 3), self.k0), record=False)

    def _proof(self, j: int, z0, record=True):
        self.spans.request = len(self.requests)
        req = Request(time.perf_counter(), gates=self.shape["gates"], point=z0,
                      witness=j)
        try:
            req.answer = self.prove(self.circuit, self.witnesses[j],
                                    backend=self.backend, z0=z0)
        except Exception as exc:          # a request that raises has failed
            req.fail(exc)
        req.end = time.perf_counter()
        if record:
            self.requests.append(req)

    def window(self, deadline: float) -> None:
        i = 0
        while time.perf_counter() < deadline:
            self._proof(i % len(self.witnesses), elements(self.z_stream, self.k0))
            i += 1

    def release(self) -> None:
        self.backend = None

    def check(self, reference, sample, control=None) -> dict:
        """Re-prove `sample` (indices into the window's proofs) with the
        reference: (compared elements, mismatched elements).  With a
        `control` (a reference of lower strength), its proofs are judged in
        the program's place."""
        from ..reference.compare import as_proof, proof_mismatches

        compared = mismatched = 0
        for i in sample:
            req = self.requests[i]
            args = (self.circ["layers"], self.circ["input_k"],
                    self.witnesses[req.witness], req.point)
            want = reference.prove(*args)
            got = req.answer if control is None else as_proof(control.prove(*args))
            c, m = proof_mismatches(got, want)
            compared += c
            mismatched += m
        return {"compared": compared, "mismatched": mismatched}

    def sample(self, g, count: int) -> list[int]:
        """`count` answered proofs drawn with g, spread over the witnesses."""
        by_w: dict[int, list[int]] = {}
        for i, r in enumerate(self.requests):
            if r.ok:
                by_w.setdefault(r.witness, []).append(i)
        out = []
        pools = [by_w[w] for w in sorted(by_w)]
        while len(out) < count and any(pools):
            for pool in pools:
                if pool and len(out) < count:
                    out.append(pool.pop(int(g.integers(len(pool)))))
        return sorted(out)
