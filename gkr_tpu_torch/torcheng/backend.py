"""TorchBackend: the prover's compute interface (layer sumcheck, MLE
structure, line restriction, sparse forms) on torch tensors, and
`prove_pipelined`, the full prove with two host syncs.

The port's counterparts of the JAX package's `JaxBackend` and
`prove_pipelined` (`jaxeng/backend.py`).  Small tables (k <=
host_threshold) go to the exact host engine: launch and sync latency
dominate below ~2^10 entries."""

from __future__ import annotations

import torch

from .. import tracing
from ..field import interpolate
from ..mimc import Mimc7, fast_transcript
from ..mle import (MleStruct, SparseMle, line, mle_struct, restrict_to_line,
                   sparse_from_dense)
from ..proof import Proof
from ..sumcheck import prove_layer_sumcheck, round_poly_len
from . import kernels as K
from . import limbs as L
from .fused import (LayerWiring, build_wiring, cached_plan, download,
                    prove_layer_sumcheck_fused)
from .sumcheck import DEVICE_TAIL, prove_layer_sumcheck_torch


def _mobius_dev(C: torch.Tensor) -> torch.Tensor:
    """Dense monomial coefficients of the MLE of a (n, 16) table (as
    `gkr_tpu_torch.mle.mobius`), in Montgomery form."""
    n = C.shape[0]
    k = n.bit_length() - 1
    for j in range(k):
        C = C.reshape(1 << j, 2, n >> (j + 1), 16)
        lo, hi = C[:, 0], C[:, 1]
        C = torch.stack([lo, L.sub_mod(hi, lo)], dim=1)
    return C.reshape(n, 16)


def _struct_scalars(C: torch.Tensor):
    """The MleStruct ingredients of a Möbius table, reduced on the device:
    (k,) support bits (MSB-first), max popcount over nonzero indices, and
    whether any coefficient is nonzero."""
    n = C.shape[0]
    k = n.bit_length() - 1
    nz = (C != 0).any(dim=-1)
    idx = torch.arange(n, device=C.device)
    bits = torch.stack([(idx >> (k - 1 - j)) & 1 for j in range(k)])   # k >= 1
    sup = (bits.bool() & nz).any(dim=1)
    pop = bits.sum(dim=0)
    maxdeg = torch.where(nz, pop, torch.zeros_like(pop)).max()
    return sup, maxdeg, nz.any()


def _struct(k: int, sup, maxdeg, any_nz) -> MleStruct:
    """The MleStruct of `_struct_scalars`' three values (on the host)."""
    if not bool(any_nz):
        return MleStruct(k, True, [False] * k, 0)
    return MleStruct(k, False, [bool(x) for x in sup.tolist()], int(maxdeg))


def _multi_point_fold(W: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Evaluate the MLE of W (n, 16) at npts points (npts, k, 16) -> (npts,
    16).  Each step's products go through `mont_mul`, one launch for all
    points."""
    npts, k = pts.shape[0], pts.shape[1]
    T = W.unsqueeze(0).expand(npts, W.shape[0], 16)
    for j in range(k):
        half = T.shape[1] // 2
        lo, hi = T[:, :half], T[:, half:]
        T = L.add_mod(lo, L.mont_mul(L.sub_mod(hi, lo), pts[:, j].contiguous()))
    return T[:, 0]


class TorchBackend:
    """Device compute backend.  Caches packed tables per layer index and
    wiring plans per gate list.

    `device=None` means the CUDA card, and raises where there is none; the
    tests pass `device="cpu"`, where every kernel wrapper runs its plain
    version.  `fused=True` (the default, as `JaxBackend`'s) runs each layer
    sumcheck on the fused engine (`torcheng.fused`); `fused=False` on the
    per-round engine (`torcheng.sumcheck`), which finishes tables below
    `tail_threshold` entries on the host."""

    # `prove_pipelined` may take this backend's place in `prove()`: it runs
    # every layer on the single-device fused engine.  A subclass whose
    # `layer_sumcheck` proves otherwise sets it False.
    pipelined = True

    def __init__(self, device=None, host_threshold: int = 10,
                 tail_threshold: int | None = None, fused: bool = True):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchBackend: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        self.host_threshold = host_threshold
        self.tail_threshold = DEVICE_TAIL if tail_threshold is None else tail_threshold
        self.fused = fused
        self._packed: dict[int, torch.Tensor] = {}
        # circuit-static wiring plans, guarded by gate-list identity, so they
        # survive reset_cache(); a different circuit passes other list objects
        self._wiring: dict[int, tuple] = {}

    # -- helpers ----------------------------------------------------------

    def _use_host(self, k: int) -> bool:
        return k <= self.host_threshold

    def reset_cache(self) -> None:
        """Called by prove() at proof start: the per-layer packed-table
        cache must not leak between circuits."""
        self._packed = {}

    def wiring(self, layer_idx: int, add_gates, mult_gates, n: int) -> LayerWiring:
        """The layer's wiring plan on the device, cached by
        `fused.cached_plan`."""
        return cached_plan(self._wiring, layer_idx, add_gates, mult_gates, n,
                           lambda: build_wiring(add_gates, mult_gates, n, self.device))

    def packed(self, layer_idx: int | None, w_values) -> torch.Tensor:
        if layer_idx is None:
            return L.pack(w_values, self.device)
        t = self._packed.get(layer_idx)
        if t is None or t.shape[0] != len(w_values):
            t = L.pack(w_values, self.device)
            self._packed[layer_idx] = t
        return t

    # -- prover interface -------------------------------------------------

    def mle_struct(self, w_values, layer_idx: int | None = None) -> MleStruct:
        k = len(w_values).bit_length() - 1
        if self._use_host(k):
            return mle_struct(w_values)
        return _struct(k, *_struct_scalars(
            _mobius_dev(self.packed(layer_idx, w_values))))

    def layer_sumcheck(self, z, w_next, add_gates, mult_gates,
                       k_cur, k_next, w_struct, transcript,
                       layer_idx: int | None = None):
        if self._use_host(k_next):
            return prove_layer_sumcheck(z, w_next, add_gates, mult_gates,
                                        k_cur, k_next, w_struct, transcript)
        w_dev = self.packed(layer_idx, w_next)
        if self.fused:
            wiring = (self.wiring(layer_idx, add_gates, mult_gates, 1 << k_next)
                      if layer_idx is not None else None)
            return prove_layer_sumcheck_fused(
                z, w_next, add_gates, mult_gates, k_cur, k_next, w_struct,
                transcript, w_dev=w_dev, wiring=wiring)
        return prove_layer_sumcheck_torch(
            z, w_next, add_gates, mult_gates, k_cur, k_next, w_struct,
            transcript, w_dev=w_dev, tail_threshold=self.tail_threshold,
            device=self.device)

    def restrict_to_line(self, w_values, b, c, struct,
                         layer_idx: int | None = None):
        k = len(b)
        if self._use_host(k):
            return restrict_to_line(w_values, b, c, struct)
        if struct.empty:
            return [0]
        deg = struct.maxdeg
        pts = [line(b, c, t) for t in range(deg + 1)]
        pts_dev = L.pack([x for pt in pts for x in pt],
                         self.device).reshape(deg + 1, k, 16)
        ys = L.unpack(_multi_point_fold(self.packed(layer_idx, w_values),
                                        pts_dev))
        return interpolate(list(zip(range(deg + 1), ys)))

    def sparse_from_dense(self, w_values):
        """Möbius transform + nonzero compaction on the device -> lazy
        SparseMle (row for row what the host transform returns)."""
        n = len(w_values)
        k = n.bit_length() - 1
        if self._use_host(k):
            return sparse_from_dense(w_values)
        C = _mobius_dev(L.pack(w_values, self.device))
        nz = (C != 0).any(dim=-1).nonzero().flatten()
        rows = L.redc(C[nz])                 # out of Montgomery form
        return SparseMle(k, nz.cpu().numpy(), rows.cpu().numpy().astype("uint32"))


# ------------------------------------------------------- pipelined prover

def _line_challenge(last: torch.Tensor, length: int) -> torch.Tensor:
    """r* on the device: MiMC of the last round's 2 or 3 coefficients, the
    rows of its (c2, c1, c0) the host proof keeps (`shape_coeffs`)."""
    return K.mimc_multi(last[3 - length:])


def prove_pipelined(circuit, w_values, transcript: Mimc7 | None = None,
                    backend: TorchBackend | None = None, z0=None,
                    materialize_sparse: bool = True) -> Proof:
    """The full prove with every layer on the device and two host syncs,
    the twin of the JAX package's `prove_pipelined`: the same `Proof` as
    `prove()`.

    Pass 1 packs every layer's table and reduces its Moebius table to the
    struct scalars, then downloads them all at once (the host needs them to
    fix each layer's round-length schedule).  Pass 2 enqueues every layer's
    fused sumcheck with no sync: the z-chain z_{i+1} = b* + (c* - b*) r*
    stays on the card, with r* the device MiMC of the last round's
    coefficients, and so do the line points' evaluations of W~.  Then one
    download of every layer's arrays; the host re-hashes every round and
    every r*, checks the device z-chain against its own, and raises
    RuntimeError on any divergence.  Every upload is asynchronous
    (`limbs.upload`), so the two downloads are the walk's only syncs; the
    sparse forms (`materialize_sparse`) come after it.

    The whole walk runs under the `walk` span, pass 1 to its download under
    `walk.pass1` (each layer's Moebius transform and struct scalars under
    `walk.mobius`), pass 2 under `walk.enqueue` (each layer's r*, z-chain
    step and line points under `walk.line`), the host's checks after the
    second download under `walk.check` (`tracing`)."""
    if transcript is None:
        transcript = Mimc7()
    if backend is None:
        backend = TorchBackend()
    with tracing.span("walk"):
        backend.reset_cache()
        depth = circuit.depth()
        assert len(w_values) == depth + 1
        dev = backend.device

        # pass 1: packed tables and their struct scalars, one download
        with tracing.span("walk.pass1"):
            packed = [backend.packed(i, w_values[i]) for i in range(1, depth + 1)]
            reduced = []
            for t in packed:
                with tracing.span("walk.mobius"):
                    reduced += _struct_scalars(_mobius_dev(t))
            scalars = download(reduced)
            structs = [_struct(circuit.k(i + 1), *scalars[3 * i:3 * i + 3])
                       for i in range(depth)]

        # pass 2: every layer enqueued, the z-chain on the device
        with tracing.span("walk.enqueue"):
            k0 = circuit.k(0)
            z0_host = list(z0) if z0 is not None else [0] * k0
            z_dev = L.pack(z0_host, dev).reshape(k0, 16)
            max_deg = max((s.maxdeg for s in structs if not s.empty), default=0)
            t_rows = L.pack(list(range(max_deg + 1)), dev)
            per_layer = []
            for i, (layer, struct) in enumerate(zip(circuit.layers, structs)):
                k_next = circuit.k(i + 1)
                wiring = backend.wiring(i + 1, layer.add_gates, layer.mult_gates,
                                        1 << k_next)
                arrays, finish = prove_layer_sumcheck_fused(
                    None, w_values[i + 1], layer.add_gates, layer.mult_gates,
                    layer.k_cur, k_next, struct, transcript, w_dev=packed[i],
                    wiring=wiring, defer=True, z_dev=z_dev)
                _co1, co2, b_dev, c_dev = arrays
                sup = struct.support if not struct.empty else [False] * k_next
                ln_last = round_poly_len(2 * k_next, 2 * k_next, sup,
                                         len(layer.add_gates) > 0,
                                         len(layer.mult_gates) > 0)
                with tracing.span("walk.line"):
                    r_star = _line_challenge(co2[-1], ln_last)
                    diff = L.sub_mod(c_dev, b_dev)
                    z_dev = L.add_mod(b_dev, L.mont_mul(diff, r_star.reshape(1, 16)))
                    # W~ on the line l(t) = b* + (c* - b*) t at t = 0..deg
                    extra = [r_star, z_dev]
                    if not struct.empty:
                        deg = struct.maxdeg
                        pts = L.add_mod(b_dev, L.mont_mul(
                            diff.expand(deg + 1, k_next, 16).contiguous(),
                            t_rows[:deg + 1]))
                        extra.append(_multi_point_fold(packed[i], pts))
                per_layer.append((arrays, extra, finish))

        # one download for the whole proof, then the host's checks
        host = iter(download([a for arrays, extra, _ in per_layer
                              for a in (*arrays, *extra)]))
        with tracing.span("walk.check"):
            hasher = fast_transcript(transcript)
            z_chain = [z0_host]
            sumcheck_proofs, sumcheck_r, q, r_stars = [], [], [], []
            for i, ((arrays, extra, finish), struct) in enumerate(
                    zip(per_layer, structs)):
                proof_i, chal_i = finish(tuple(next(host) for _ in arrays))
                r_dev, z_next_dev = next(host), next(host)
                k_next = circuit.k(i + 1)
                r_star = hasher.multi_hash(proof_i[-1], 0)
                if r_star != L.unpack_scalar(r_dev):
                    raise RuntimeError(f"device/host Fiat-Shamir divergence at "
                                       f"layer {i} r*")
                z_next = line(chal_i[:k_next], chal_i[k_next:], r_star)
                if L.unpack(z_next_dev) != z_next:
                    raise RuntimeError(f"device/host z-chain divergence after "
                                       f"layer {i}")
                sumcheck_proofs.append(proof_i)
                sumcheck_r.append(chal_i)
                r_stars.append(r_star)
                z_chain.append(z_next)
                if struct.empty:
                    q.append([0])
                else:
                    ys = L.unpack(next(host))
                    q.append(interpolate(list(zip(range(struct.maxdeg + 1), ys))))

        if materialize_sparse:
            with tracing.span("backend.sparse_from_dense"):
                d_sparse = backend.sparse_from_dense(w_values[0])
            with tracing.span("backend.sparse_from_dense"):
                input_sparse = backend.sparse_from_dense(w_values[depth])
        else:
            d_sparse, input_sparse = [], []
    return Proof(sumcheck_proofs=sumcheck_proofs, sumcheck_r=sumcheck_r,
                 d=d_sparse, q=q, z=z_chain, r=r_stars, depth=depth + 1,
                 input_func=input_sparse, k=circuit.k_list())
