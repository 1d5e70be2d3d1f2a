"""Device-resident GKR layer sumcheck: the fused engine.

The port's counterpart of the JAX package's default engine,
`prove_layer_sumcheck_fused` (`jaxeng/fused.py`).  Per layer:

  * the wiring plan (host, numpy, once per circuit): for each phase the gate
    triples sorted stably by that phase's bucket key (left input for phase
    1, right input for phase 2), the companion index columns stored in that
    order, and the bucket boundaries `hib`;
  * the phase-1 build: eq(z) by the `eq_table` kernel, gathers of the
    pre-sorted columns (`index_select`), products by `mont_mul`, per-bucket
    sums by `seg_sum`, `normalize`, and `stack` into the (n, 4, 16) stack
    [W, HA1, HA2, HM];
  * the round chain, every round on the card: `phase*_partials` ->
    `round_coeffs` -> `mimc_multi` (the round's 2 or 3 coefficients, from
    the host's structural schedule) -> `fold` reading the challenge from
    device memory.  Tables halve every round down to one entry;
  * the phase-2 build from the device challenges b*: eq(b*), FA by
    `normalize`, FM * W~(b*) by `normalize` with the scalar, `stack` into
    [W, FA, FMwb];
  * one download per layer of the coefficients and challenges, after which
    the host re-hashes every round with its own MiMC7 and raises on any
    divergence.

There is no host synchronisation inside a layer before the download.  Each
stage runs under a `fused.*` torch.profiler span.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..mimc import Mimc7
from ..mle import MleStruct
from ..sumcheck import round_poly_len, shape_coeffs
from . import kernels as K
from . import limbs as L


class PhasePlan(NamedTuple):
    """One gate list keyed for one phase, on the device."""
    out: torch.Tensor      # (G,) int64 output-gate index, in key order
    other: torch.Tensor    # (G,) int64 the non-key input's index, same order
    hib: torch.Tensor      # (n,) int32: number of gates with key <= b


class LayerWiring(NamedTuple):
    """The plans of a layer: add and mult gates for phase 1 (keyed by the
    left input) and phase 2 (keyed by the right input); None for an empty
    gate list."""
    a1: PhasePlan | None
    m1: PhasePlan | None
    a2: PhasePlan | None
    m2: PhasePlan | None


def _gate_columns(gates) -> np.ndarray:
    """Gate triples -> (3, G) int64 [out, left, right]."""
    g = np.fromiter(itertools.chain.from_iterable(gates), dtype=np.int64,
                    count=3 * len(gates))
    return g.reshape(-1, 3).T


def _plan(cols: np.ndarray, key: int, n: int, device) -> PhasePlan:
    keys = cols[key]
    perm = np.argsort(keys, kind="stable")
    hib = np.cumsum(np.bincount(keys, minlength=n))
    other = cols[3 - key]           # right for key = left, left for key = right

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return PhasePlan(dev(cols[0][perm], torch.int64),
                     dev(other[perm], torch.int64),
                     dev(hib, torch.int32))


def build_wiring(add_gates, mult_gates, n: int, device="cpu") -> LayerWiring:
    """The host plan of a layer with 2^k = n entries in its next layer.  It
    depends only on the wiring, so a backend computes it once per circuit."""
    plans = []
    with record_function("fused.wiring_plan"):
        for gates in (add_gates, mult_gates):
            cols = _gate_columns(gates) if gates else None
            plans.append([None if cols is None else _plan(cols, key, n, device)
                          for key in (1, 2)])
    (a1, a2), (m1, m2) = plans
    return LayerWiring(a1, m1, a2, m2)


# ------------------------------------------------------------------ builds

def _build_phase1(w_dev, z_dev, wiring: LayerWiring):
    """-> the (n, 4, 16) stack [W, HA1, HA2, HM] and eq(z) for phase 2:
    HA1[b] = sum eq(z, out) and HA2[b] = sum eq(z, out) W[right] over the
    add gates with left b, HM[b] = the mult gates' sum of the latter."""
    eqz = K.eq_table(z_dev)
    ha1 = ha2 = hm = None                   # zeros in the stack
    if wiring.a1 is not None:
        p = wiring.a1
        wa = eqz.index_select(0, p.out)
        rel = K.seg_sum([wa, K.mont_mul(wa, w_dev.index_select(0, p.other))],
                        p.hib)
        ha1, ha2 = K.normalize(rel[0]), K.normalize(rel[1])
    if wiring.m1 is not None:
        p = wiring.m1
        prod = K.mont_mul(eqz.index_select(0, p.out),
                          w_dev.index_select(0, p.other))
        hm = K.normalize(K.seg_sum([prod], p.hib)[0])
    return K.stack([w_dev, ha1, ha2, hm]), eqz


def _build_phase2(w_dev, b_star, wb, eqz, wiring: LayerWiring):
    """-> the (n, 3, 16) stack [W, FA, FM * wb]: FA[c] (FM[c]) sums
    eq(z, out) eq(b*, left) over the add (mult) gates with right c."""
    eqb = K.eq_table(b_star)

    def table(p: PhasePlan | None, scalar=None):
        if p is None:
            return None                     # zeros in the stack
        prod = K.mont_mul(eqz.index_select(0, p.out), eqb.index_select(0, p.other))
        return K.normalize(K.seg_sum([prod], p.hib)[0], scalar)

    return K.stack([w_dev, table(wiring.a2), table(wiring.m2, wb)])


# ------------------------------------------------------------- round chain

def _run_phase(S, sched, wb=None):
    """Every round of one phase on the card: -> (the one-entry stack,
    (len(sched), 3, 16) coefficients (c2, c1, c0), (len(sched), 16)
    challenges)."""
    coeffs, rs = [], []
    for length in sched:
        part = K.phase1_partials(S) if wb is None else K.phase2_partials(S, wb)
        co = K.round_coeffs(part)
        r = K.mimc_multi(co[3 - length:])
        coeffs.append(co)
        rs.append(r)
        S = K.fold(S, r)
    return S, torch.stack(coeffs), torch.stack(rs)


def download(device_arrays):
    """The layer's coefficients and challenges to the host in one copy."""
    flat = torch.cat([a.reshape(-1, 16) for a in device_arrays]).cpu()
    return tuple(torch.split(flat, [a.numel() // 16 for a in device_arrays]))


def prove_layer_sumcheck_fused(
    z: list[int],
    w_next: list[int],
    add_gates, mult_gates,
    k_cur: int, k_next: int,
    w_struct: MleStruct,
    transcript: Mimc7,
    w_dev: torch.Tensor | None = None,
    wiring: LayerWiring | None = None,
    defer: bool = False,
    z_dev: torch.Tensor | None = None,
    device="cuda",
):
    """Drop-in replacement for `gkr_tpu_torch.sumcheck.prove_layer_sumcheck`
    with the whole layer on `device` and one download; the transcript is
    re-derived on the host and must equal the device's.

    `w_dev` is W_{i+1} already packed on the device, `z_dev` the point z as
    (k_cur, 16) device limbs, `wiring` a cached `build_wiring` plan; each is
    made here when None.  `defer=True` returns (device_arrays, finish)
    without synchronising: `finish(download(device_arrays))` gives
    (proof, challenges) and raises RuntimeError on a Fiat-Shamir
    divergence."""
    k = k_next
    v = 2 * k
    assert v >= 2
    if transcript.n_rounds != K.MIMC_ROUNDS:
        raise ValueError(f"the device Fiat-Shamir hash is MiMC7-"
                         f"{K.MIMC_ROUNDS}, not {transcript.n_rounds} rounds")
    sup = w_struct.support if not w_struct.empty else [False] * k
    sched = tuple(round_poly_len(j, v, sup, len(add_gates) > 0,
                                 len(mult_gates) > 0) for j in range(1, v + 1))
    if any(length not in (2, 3) for length in sched):
        raise ValueError(f"round polynomial lengths {sched} out of the "
                         f"protocol's range")
    n = 1 << k

    if w_dev is None:
        w_dev = L.pack(w_next, device)
    device = w_dev.device
    if z_dev is None:
        z_dev = L.pack(z, device).reshape(-1, 16)
    if wiring is None:
        wiring = build_wiring(add_gates, mult_gates, n, device)

    with record_function("fused.build_phase1"):
        S1, eqz = _build_phase1(w_dev, z_dev, wiring)
    with record_function("fused.phase1_rounds"):
        S1, co1, rs1 = _run_phase(S1, sched[:k])
    wb = S1[0, 0]
    with record_function("fused.build_phase2"):
        S2 = _build_phase2(w_dev, rs1, wb, eqz, wiring)
    del eqz
    with record_function("fused.phase2_rounds"):
        _, co2, rs2 = _run_phase(S2, sched[k:], wb)

    def finish(host_arrays):
        h1, h2, hr1, hr2 = host_arrays
        flat = L.unpack(torch.cat([h1.reshape(-1, 16), h2.reshape(-1, 16)]))
        rs_device = L.unpack(torch.cat([hr1, hr2]))
        proof: list[list[int]] = []
        challenges: list[int] = []
        for j in range(1, v + 1):
            coeffs = shape_coeffs(flat[3 * (j - 1):3 * j], sched[j - 1])
            proof.append(coeffs)
            r = transcript.multi_hash(coeffs, 0)
            if r != rs_device[j - 1]:
                raise RuntimeError(
                    f"device/host Fiat-Shamir divergence at round {j}")
            challenges.append(r)
        return proof, challenges

    device_arrays = (co1, co2, rs1, rs2)
    if defer:
        return device_arrays, finish
    with record_function("fused.download_and_check"):
        return finish(download(device_arrays))
