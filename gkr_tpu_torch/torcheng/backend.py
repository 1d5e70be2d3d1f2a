"""TorchBackend: the prover's compute interface (layer sumcheck, MLE
structure, line restriction, sparse forms) on torch tensors.

The port's counterpart of the JAX package's `JaxBackend`
(`jaxeng/backend.py`).  Small tables (k <= host_threshold) go to the exact
host engine: launch and sync latency dominate below ~2^10 entries."""

from __future__ import annotations

import torch

from ..field import interpolate
from ..mle import (MleStruct, SparseMle, line, mle_struct, restrict_to_line,
                   sparse_from_dense)
from ..sumcheck import prove_layer_sumcheck
from . import limbs as L
from .fused import LayerWiring, build_wiring, prove_layer_sumcheck_fused
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
        """The layer's wiring plan on the device, keyed by the gate lists'
        identity, their lengths and n.  Gate lists are taken as immutable
        once proved: an element overwritten in place in the same list object
        goes unseen (build a fresh circuit instead)."""
        key = (len(add_gates), len(mult_gates), n)
        ent = self._wiring.get(layer_idx)
        if (ent is not None and ent[0] is add_gates and ent[1] is mult_gates
                and ent[2] == key):
            return ent[3]
        w = build_wiring(add_gates, mult_gates, n, self.device)
        self._wiring[layer_idx] = (add_gates, mult_gates, key, w)
        return w

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
        sup, maxdeg, any_nz = _struct_scalars(
            _mobius_dev(self.packed(layer_idx, w_values)))
        if not bool(any_nz):
            return MleStruct(k, True, [False] * k, 0)
        return MleStruct(k, False, [bool(x) for x in sup.tolist()],
                         int(maxdeg))

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
