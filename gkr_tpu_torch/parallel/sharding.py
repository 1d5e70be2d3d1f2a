"""The multi-device layer sumcheck: one prove() drives D shards.

The port's counterpart of the JAX package's sharded engine
(`gkr_tpu/parallel/sharding.py`: `make_mesh`, `ShardedSumcheck`,
`ShardedBackend`), on the fused engine's kernels (`torcheng/fused.py`).  It
adds no kernel.  Single controller: this process launches every shard's
work, each on its shard's device.

  * **The mesh** is an ordered list of D torch devices, D a power of two.
    A device may appear more than once: D shards then share it, each with
    its own tables (that is how one card, or the CPU, runs D shards).
  * **Layout**: the global hypercube index is b = row * D + dev, so the
    shard index carries the LOW bits of b, the last sumcheck variables of
    a phase; shard `dev` owns the buckets b = dev (mod D), `rows` = n / D
    of them.  Its stack holds W's rows b = row * D + dev and its own
    wiring tables.
  * **Builds**: the gates are partitioned on the host by their phase's key
    mod D and re-keyed to key // D, and each shard runs the wiring plan,
    the segment sum and the normalisation on its own gates.  W (for the
    W[right] gathers) and eq(z) are replicated on each distinct device.
    eq(b*, left) factorises over the split of b*'s bits,
    eq_hi[left // D] * eq_lo[left % D] with eq_hi over the top k - log2 D
    challenges (rows entries) and eq_lo over the last log2 D (D entries),
    so no shard builds a full-size eq(b*) table.
  * **A round** while a shard holds 2 rows or more: each shard sums its
    rows' round terms at t = 0, 1, 2 with the eval kernel (the sum taken
    in its last block); the D (3, 16) sums are gathered onto the lead
    device (the JAX engine's one 192-byte psum); one `round_tail` launch
    at G = D reduces them mod p, interpolates and hashes, exactly as the
    single-device round's tail reduces its block partials, so the round's
    coefficients and challenge are the single-device ones; r goes back to
    each shard, which folds its rows' MSB with the fold kernel.
  * **The tail**: at one row a shard, the D survivors, in shard order the
    entries b = 0 .. D - 1, are gathered into one (D, t, 16) stack on the
    lead device, and the last log2 D rounds of the phase run there as the
    fused engine's rounds.
  * **One download a layer**, after which the host re-hashes every round
    and raises RuntimeError on a divergence.  A layer whose table has
    fewer than 2 rows a shard goes to the exact host engine.

The JAX engine's replicated-buffer scan of the short rounds and its
transposed layout are left out: a CUDA grid is sized at each launch, so the
tables halve every round.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..mimc import Mimc7
from ..mle import MleStruct
from ..sumcheck import prove_layer_sumcheck
from ..torcheng import fused as F
from ..torcheng import kernels as K
from ..torcheng import limbs as L
from ..torcheng.backend import TorchBackend


def make_mesh(n_devices: int | None = None, devices=None,
              hosts: int | None = None) -> list[torch.device]:
    """The ordered devices of D shards: `devices` (default every visible
    CUDA card), repeated in turn up to `n_devices` where fewer are given,
    or cut to its first `n_devices`.  D must be a power of two.  Without a
    card, `devices=None` raises: pass `devices=["cpu"] * D` for D shards on
    the CPU.  `hosts` (a mesh over several processes) is not implemented."""
    if hosts is not None:
        raise NotImplementedError("make_mesh(hosts=...): a mesh over several "
                                  "processes is not implemented")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass "
                               "devices=['cpu'] * D to run D shards on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in mesh) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device")
    mesh = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in mesh]
    if n_devices is not None:
        mesh = [mesh[i % len(mesh)] for i in range(n_devices)] if mesh else []
    D = len(mesh)
    if D < 1 or D & (D - 1):
        raise ValueError(f"a mesh of {D} shards: D must be a power of two")
    return mesh


def distinct(mesh) -> list[torch.device]:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def shard_plans(add_gates, mult_gates, n: int, mesh) -> list[F.LayerWiring]:
    """Each shard's wiring plan of a layer with 2^k = n entries in its next
    layer, on the shard's device: the gates whose phase key is = dev
    (mod D), keyed by key // D over the shard's n / D rows; the other
    input keeps its global index."""
    D = len(mesh)
    rows = n // D
    with record_function("sharded.wiring_plan"):
        cols = [F.gate_columns(g) if g else None for g in (add_gates, mult_gates)]
        plans = []
        for dev, device in enumerate(mesh):
            kinds = []
            for c in cols:
                per_key = []
                for key in (1, 2):
                    mine = None if c is None else c[:, c[key] % D == dev]
                    if mine is None or mine.shape[1] == 0:
                        per_key.append(None)
                        continue
                    mine[key] //= D
                    per_key.append(F.phase_plan(mine, key, rows, device))
                kinds.append(per_key)
            (a1, a2), (m1, m2) = kinds
            plans.append(F.LayerWiring(a1, m1, a2, m2))
    return plans


class ShardedSumcheck:
    """The layer sumcheck over a mesh of D shards (`make_mesh(devices=mesh)`,
    every visible card by default); a drop-in for
    `sumcheck.prove_layer_sumcheck`.  It keeps each layer's `shard_plans`,
    by layer index, while the layer's gate lists stay the same objects."""

    def __init__(self, mesh=None):
        self.mesh = make_mesh(devices=mesh)
        self.D = len(self.mesh)
        self.log_d = self.D.bit_length() - 1
        self.lead = self.mesh[0]
        self._plans: dict[int, tuple] = {}

    def _rounds(self, S: list[torch.Tensor], sched, wb=None):
        """Every round of one phase over the shards' stacks S (rows, t, 16)
        (`wb` a dict of W~(b*) by device for phase 2) -> (the one-entry
        stack on the lead device, (len(sched), 3, 16) coefficients,
        (len(sched), 16) challenges)."""
        lead = self.lead
        coeffs, rs = [], []
        j = 0
        while S[0].shape[0] >= 2:
            ys = [K.phase1_eval(s) if wb is None else K.phase2_eval(s, wb[s.device])
                  for s in S]
            co, r = K.round_tail(torch.stack([y.to(lead, non_blocking=True)
                                              for y in ys]), sched[j])
            coeffs.append(co)
            rs.append(r)
            on = {d: r.to(d, non_blocking=True) for d in distinct(self.mesh)}
            S = [K.fold(s, on[s.device]) for s in S]
            j += 1
        last = torch.cat([s.to(lead, non_blocking=True) for s in S])   # (D, t, 16)
        if j < len(sched):
            last, co_t, rs_t = F.run_phase(last, sched[j:],
                                           None if wb is None else wb[lead])
            coeffs.append(co_t)
            rs.append(rs_t)
        return (last, torch.cat([c.reshape(-1, 3, 16) for c in coeffs]),
                torch.cat([r.reshape(-1, 16) for r in rs]))

    def prove_layer_sumcheck(self, z, w_next, add_gates, mult_gates,
                             k_cur: int, k_next: int, w_struct: MleStruct,
                             transcript: Mimc7, w_dev: torch.Tensor | None = None,
                             layer_idx: int | None = None):
        """The layer's (proof, challenges), equal to the host engine's; a
        table of fewer than 2 rows a shard goes to the exact host engine.
        `w_dev` is W_{i+1} packed on the lead device (packed here when
        None); `layer_idx` keys the layer's plans (made anew when None)."""
        k = k_next
        n = 1 << k
        D, ld, lead = self.D, self.log_d, self.lead
        if n // D < 2:
            return prove_layer_sumcheck(z, w_next, add_gates, mult_gates,
                                        k_cur, k_next, w_struct, transcript)
        sched = F.round_schedule(transcript, w_struct, k, add_gates, mult_gates)
        rows = n // D
        if w_dev is None:
            w_dev = L.pack(w_next, lead)

        def make():
            return shard_plans(add_gates, mult_gates, n, self.mesh)

        plans = make() if layer_idx is None else F.cached_plan(
            self._plans, layer_idx, add_gates, mult_gates, n, make)
        z_dev = L.pack(z, lead).reshape(-1, 16)

        with record_function("sharded.build_phase1"):
            w_on, eqz_on = {}, {}
            for d in distinct(self.mesh):
                w_on[d] = w_dev.to(d, non_blocking=True)
                eqz_on[d] = K.eq_table(z_dev.to(d, non_blocking=True))
            # shard dev's rows of W: b = row * D + dev
            w_rows = [w_on[d].view(rows, D, 16)[:, dev].contiguous()
                      for dev, d in enumerate(self.mesh)]
            S1 = [K.stack([w_rows[dev], *F.phase1_tables(w_on[d], eqz_on[d], plans[dev])])
                  for dev, d in enumerate(self.mesh)]
        with record_function("sharded.phase1_rounds"):
            fin1, co1, rs1 = self._rounds(S1, sched[:k])
        del S1
        with record_function("sharded.build_phase2"):
            wb_on, eq_on, S2 = {}, {}, []
            for d in distinct(self.mesh):
                wb_on[d] = fin1[0, 0].to(d, non_blocking=True)
                b_star = rs1.to(d, non_blocking=True)
                eq_on[d] = (K.eq_table(b_star[:k - ld]), K.eq_table(b_star[k - ld:]))
            for dev, d in enumerate(self.mesh):
                eq_hi, eq_lo = eq_on[d]

                def eqb_at(left, eq_hi=eq_hi, eq_lo=eq_lo):
                    return K.mont_mul(eq_hi.index_select(0, left >> ld),
                                      eq_lo.index_select(0, left & (D - 1)))

                S2.append(K.stack([w_rows[dev], *F.phase2_tables(
                    eqz_on[d], eqb_at, wb_on[d], plans[dev])]))
            del eqz_on, eq_on
        with record_function("sharded.phase2_rounds"):
            _, co2, rs2 = self._rounds(S2, sched[k:], wb_on)
        with record_function("sharded.download_and_check"):
            h = F.download((co1, co2, rs1, rs2))
            return F.check_transcript(torch.cat(h[:2]), torch.cat(h[2:]),
                                      sched, transcript)


class ShardedBackend(TorchBackend):
    """`TorchBackend` whose layer sumcheck runs on the sharded engine over
    `mesh` (default `make_mesh()`: every visible card, raising without
    one).  Every other stage (MLE structure, line restriction, sparse
    forms) runs on the lead device, mesh[0]; layers with k_next <=
    host_threshold go to the exact host engine.  `prove_pipelined`, which
    proves on one device, never takes its place (`pipelined`)."""

    pipelined = False

    def __init__(self, mesh=None, host_threshold: int = 10):
        self._sharded = ShardedSumcheck(mesh)
        self.mesh = self._sharded.mesh
        super().__init__(device=self._sharded.lead, host_threshold=host_threshold)

    def layer_sumcheck(self, z, w_next, add_gates, mult_gates,
                       k_cur, k_next, w_struct, transcript,
                       layer_idx: int | None = None):
        if self._use_host(k_next):
            return prove_layer_sumcheck(z, w_next, add_gates, mult_gates,
                                        k_cur, k_next, w_struct, transcript)
        return self._sharded.prove_layer_sumcheck(
            z, w_next, add_gates, mult_gates, k_cur, k_next, w_struct,
            transcript, w_dev=self.packed(layer_idx, w_next), layer_idx=layer_idx)
