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

**Several controllers** (`make_mesh(hosts=H)`, the JAX engine's
("dcn", "ici") mesh over `jax.distributed` processes): H processes of one
`torch.distributed` default group each drive D_local shards, rank r owning
the global shards dev = r * D_local + i (host-major, as JAX's device
order), so D = H * D_local and the layout above holds unchanged.  Every
rank holds the same full inputs and builds only its own shards' plans and
tables.  A round's D_local sums go to every rank by one `all_gather`, and
every rank runs the same `round_tail` at G = D: it is deterministic, so
the challenge is the same everywhere with no broadcast (the JAX engine's
one 192-byte psum a round).  The tail's survivors are all-gathered the
same way and every rank runs the tail.  After each layer's download the
ranks exchange a digest of its challenges and every rank raises
RuntimeError where any differs.  Over NCCL the collectives take device
tensors; over any other backend (gloo) their few hundred bytes are staged
through host memory.  `COLLECTIVES` counts each gather and its bytes, the
single controller's gathers onto the lead device too.

The JAX engine's replicated-buffer scan of the short rounds and its
transposed layout are left out: a CUDA grid is sized at each launch, so the
tables halve every round.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import tracing
from ..mimc import Mimc7
from ..mle import MleStruct
from ..sumcheck import prove_layer_sumcheck
from ..torcheng import fused as F
from ..torcheng import kernels as K
from ..torcheng import limbs as L
from ..torcheng.backend import TorchBackend


@dataclass(frozen=True)
class HostMesh:
    """A mesh over the `hosts` processes of the default process group:
    this rank's `devices` hold the global shards rank * len(devices) + i of
    D = hosts * len(devices); `backend` is the group's ("nccl", "gloo")."""
    hosts: int
    rank: int
    D: int
    devices: tuple[torch.device, ...]
    backend: str

    @property
    def first(self) -> int:
        return self.rank * len(self.devices)


# Collectives of the sharded engine by kind, and the bytes each gathered on
# this process: "round" (a round's D sums), "tail" (the D one-row stacks),
# "digest" (the layer's challenge digests), "mesh" (make_mesh's check).
COLLECTIVES = {"round": 0, "tail": 0, "digest": 0, "mesh": 0}
COLLECTIVE_BYTES = dict.fromkeys(COLLECTIVES, 0)


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = COLLECTIVE_BYTES[k] = 0


def _count(kind: str, t: torch.Tensor) -> torch.Tensor:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()
    return t


def all_gather(t: torch.Tensor, backend: str, kind: str) -> torch.Tensor:
    """Every rank's `t`, concatenated along dim 0 in rank order, on t's
    device.  Over NCCL the device tensor goes on the wire; over any other
    backend an explicit host copy does."""
    src = t if backend == "nccl" else t.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    return _count(kind, torch.cat(parts).to(t.device, non_blocking=True))


def _devices(n_devices: int | None, devices) -> list[torch.device]:
    """`devices` (default every visible CUDA card), repeated in turn up to
    `n_devices` where fewer are given, or cut to its first `n_devices`."""
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
    return mesh


def _check_power_of_two(D: int) -> None:
    if D < 1 or D & (D - 1):
        raise ValueError(f"a mesh of {D} shards: D must be a power of two")


def make_mesh(n_devices: int | None = None, devices=None,
              hosts: int | None = None):
    """The ordered devices of D shards: `devices` (default every visible
    CUDA card), repeated in turn up to `n_devices` where fewer are given,
    or cut to its first `n_devices`.  D must be a power of two.  Without a
    card, `devices=None` raises: pass `devices=["cpu"] * D` for D shards on
    the CPU.

    `hosts=H`: a `HostMesh` over the H processes of the initialized default
    process group (world size H), this rank's shards on `devices` (chosen
    as above).  Every rank must pass the same number of shards (checked by
    one collective); D = H * that number must be a power of two."""
    mesh = _devices(n_devices, devices)
    if hosts is None:
        _check_power_of_two(len(mesh))
        return mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"make_mesh(hosts={hosts}): no initialized default "
                           "process group (call torch.distributed."
                           "init_process_group first)")
    if dist.get_world_size() != hosts:
        raise ValueError(f"make_mesh(hosts={hosts}): the default process group "
                         f"has {dist.get_world_size()} processes")
    if not mesh:
        raise ValueError("make_mesh: a rank with no shards")
    backend = dist.get_backend()
    on = mesh[0] if backend == "nccl" else torch.device("cpu")
    counts = all_gather(torch.tensor([len(mesh)], device=on), backend,
                        "mesh").tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"make_mesh(hosts={hosts}): the ranks hold {counts} "
                         "shards; every rank must hold the same number")
    _check_power_of_two(hosts * len(mesh))
    return HostMesh(hosts, dist.get_rank(), hosts * len(mesh), tuple(mesh), backend)


def local_devices(mesh) -> list[torch.device]:
    """This process's shard devices of a mesh (a list or a HostMesh)."""
    return list(mesh.devices) if isinstance(mesh, HostMesh) else list(mesh)


def distinct(mesh) -> list[torch.device]:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def shard_plans(add_gates, mult_gates, n: int, mesh) -> list[F.LayerWiring]:
    """The wiring plans of this process's shards of a layer with 2^k = n
    entries in its next layer, each on its shard's device: shard dev's
    gates are those whose phase key is = dev (mod D), keyed by key // D
    over the shard's n / D rows; the other input keeps its global index."""
    if isinstance(mesh, HostMesh):
        D, first = mesh.D, mesh.first
    else:
        D, first = len(mesh), 0
    rows = n // D
    with tracing.span("sharded.wiring_plan"):
        cols = [F.gate_columns(g) if g else None for g in (add_gates, mult_gates)]
        plans = []
        for i, device in enumerate(local_devices(mesh)):
            dev = first + i
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
    every visible card by default, or a `HostMesh` of several processes);
    a drop-in for `sumcheck.prove_layer_sumcheck`.  It keeps each layer's
    `shard_plans`, by layer index, while the layer's gate lists stay the
    same objects."""

    def __init__(self, mesh=None):
        self.mesh = mesh if isinstance(mesh, HostMesh) else make_mesh(devices=mesh)
        self.local = local_devices(self.mesh)
        self.hosts = self.mesh if isinstance(self.mesh, HostMesh) else None
        self.D = len(self.local) if self.hosts is None else self.hosts.D
        self.log_d = self.D.bit_length() - 1
        self.lead = self.local[0]
        self._plans: dict[int, tuple] = {}

    def _gather(self, parts: list[torch.Tensor], kind: str) -> torch.Tensor:
        """This process's shards' tensors, stacked on the lead device in
        shard order, then every rank's in global shard order."""
        local = torch.cat([t.to(self.lead, non_blocking=True) for t in parts])
        if self.hosts is None:
            return _count(kind, local)
        return all_gather(local, self.hosts.backend, kind)

    def _rounds(self, S: list[torch.Tensor], sched, wb=None):
        """Every round of one phase over the local shards' stacks S
        (rows, t, 16) (`wb` a dict of W~(b*) by device for phase 2) -> (the
        one-entry stack on the lead device, (len(sched), 3, 16)
        coefficients, (len(sched), 16) challenges)."""
        lead = self.lead
        coeffs, rs = [], []
        j = 0
        while S[0].shape[0] >= 2:
            ys = [K.phase1_eval(s) if wb is None else K.phase2_eval(s, wb[s.device])
                  for s in S]
            co, r = K.round_tail(self._gather([y[None] for y in ys], "round"),
                                 sched[j])
            coeffs.append(co)
            rs.append(r)
            on = {d: r.to(d, non_blocking=True) for d in distinct(self.local)}
            S = [K.fold(s, on[s.device]) for s in S]
            j += 1
        last = self._gather(S, "tail")                                  # (D, t, 16)
        if j < len(sched):
            last, co_t, rs_t = F.run_phase(last, sched[j:],
                                           None if wb is None else wb[lead])
            coeffs.append(co_t)
            rs.append(rs_t)
        return (last, torch.cat([c.reshape(-1, 3, 16) for c in coeffs]),
                torch.cat([r.reshape(-1, 16) for r in rs]))

    def _agree(self, rs: tuple[torch.Tensor, ...]) -> None:
        """Raise RuntimeError on every rank unless every rank downloaded the
        same challenges for the layer."""
        h = hashlib.sha256(b"".join(r.numpy().tobytes() for r in rs)).digest()
        mine = torch.frombuffer(bytearray(h), dtype=torch.int64)
        on = self.lead if self.hosts.backend == "nccl" else torch.device("cpu")
        every = all_gather(mine.to(on), self.hosts.backend, "digest").cpu()
        if not bool((every.view(-1, mine.numel()) == mine).all()):
            raise RuntimeError(f"rank {self.hosts.rank}: the ranks' challenges "
                               "differ for this layer")

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
        first = 0 if self.hosts is None else self.hosts.first
        if w_dev is None:
            w_dev = L.pack(w_next, lead)

        def make():
            return shard_plans(add_gates, mult_gates, n, self.mesh)

        plans = make() if layer_idx is None else F.cached_plan(
            self._plans, layer_idx, add_gates, mult_gates, n, make)
        z_dev = L.pack(z, lead).reshape(-1, 16)

        with tracing.span("sharded.build_phase1"):
            w_on, eqz_on = {}, {}
            for d in distinct(self.local):
                w_on[d] = w_dev.to(d, non_blocking=True)
                eqz_on[d] = K.eq_table(z_dev.to(d, non_blocking=True))
            # shard dev's rows of W: b = row * D + dev
            w_rows = [w_on[d].view(rows, D, 16)[:, first + i].contiguous()
                      for i, d in enumerate(self.local)]
            S1 = [K.stack([w_rows[i], *F.phase1_tables(w_on[d], eqz_on[d], plans[i])])
                  for i, d in enumerate(self.local)]
        with tracing.span("sharded.phase1_rounds"):
            fin1, co1, rs1 = self._rounds(S1, sched[:k])
        del S1
        with tracing.span("sharded.build_phase2"):
            wb_on, eq_on, S2 = {}, {}, []
            for d in distinct(self.local):
                wb_on[d] = fin1[0, 0].to(d, non_blocking=True)
                b_star = rs1.to(d, non_blocking=True)
                eq_on[d] = (K.eq_table(b_star[:k - ld]), K.eq_table(b_star[k - ld:]))
            for i, d in enumerate(self.local):
                eq_hi, eq_lo = eq_on[d]

                def eqb_at(left, eq_hi=eq_hi, eq_lo=eq_lo):
                    return K.mont_mul(eq_hi.index_select(0, left >> ld),
                                      eq_lo.index_select(0, left & (D - 1)))

                S2.append(K.stack([w_rows[i], *F.phase2_tables(
                    eqz_on[d], eqb_at, wb_on[d], plans[i])]))
            del eqz_on, eq_on
        with tracing.span("sharded.phase2_rounds"):
            _, co2, rs2 = self._rounds(S2, sched[k:], wb_on)
        with tracing.span("sharded.download_and_check"):
            h = F.download((co1, co2, rs1, rs2))
            if self.hosts is not None:
                self._agree(h[2:])
            return F.check_transcript(torch.cat(h[:2]), torch.cat(h[2:]),
                                      sched, transcript)


class ShardedBackend(TorchBackend):
    """`TorchBackend` whose layer sumcheck runs on the sharded engine over
    `mesh` (default `make_mesh()`: every visible card, raising without
    one; a `HostMesh` on each rank of several processes, every rank then
    proving the whole circuit).  Every other stage (MLE structure, line
    restriction, sparse forms) runs on the lead device, this process's
    first shard's; layers with k_next <=
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
