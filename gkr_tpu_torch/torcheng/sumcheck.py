"""GKR layer sumcheck on torch tensors: the per-round engine.

The port's counterpart of the JAX package's `jaxeng/sumcheck.py`
(`prove_layer_sumcheck_jax`): the same two-phase linear-time algorithm as
the exact host engine (`gkr_tpu_torch.sumcheck`) with the tables held on
the device as Montgomery limb tensors:

  * the phase-1 tables (W, HA1, HA2, HM) and the phase-2 tables (W, FA,
    FMwb) are stacked on a middle axis, (n, T, 16);
  * each round, one `phase*_eval` kernel gives g_j(0), g_j(1), g_j(2); the
    96 bytes come back to the host, which derives the coefficient vector
    and the MiMC challenge, uploads the challenge, and one `fold` kernel
    binds the round variable.  The tables halve every round;
  * wiring tables are built by a gather and an `index_add_` scatter of
    per-gate eq weights into int64 relaxed limbs, normalized once;
  * below `tail_threshold` entries the tables come down and the rounds
    finish on the exact host engine.

Each stage runs under a `sumcheck.*` torch.profiler span, which records
only while a profiler runs.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.profiler import record_function

from ..mimc import Mimc7
from ..mle import MleStruct
from ..sumcheck import make_emitter, phase1_host_rounds, phase2_host_rounds
from . import kernels as K
from . import limbs as L

# Below this table size the remaining rounds run on the exact host engine:
# per-round launch and sync latency dominate tiny tables, and the tail costs
# O(threshold) host multiplications in all.
DEVICE_TAIL = 1 << 12


def gate_arrays(gates, device) -> torch.Tensor:
    """Gate triples -> (3, G) int64 index tensor [out, left, right]."""
    g = np.fromiter(itertools.chain.from_iterable(gates), dtype=np.int64,
                    count=3 * len(gates)).reshape(-1, 3)
    return torch.from_numpy(np.ascontiguousarray(g.T)).to(device)


def _scatter(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """table[b] = sum of vals[g] over idx[g] == b, canonical.  The int64
    relaxed sums stay inside `limbs.redc`'s contract for up to 2^24 gates."""
    acc = torch.zeros((n, 16), dtype=torch.int64, device=vals.device)
    acc.index_add_(0, idx, vals.to(torch.int64))
    return L.normalize_relaxed(acc)


def _build_phase1_tables(eqz, w_dev, g, n):
    """HA1/HVAL tables of one gate kind: h_cnt[b] = sum eq(z, out) over
    gates with left b, h_val[b] = sum eq(z, out) * W[right]."""
    if g.shape[1] == 0:
        z = torch.zeros((n, 16), dtype=L.LIMB_DTYPE, device=w_dev.device)
        return z, z
    out_i, l_i, r_i = g
    w = eqz[out_i]
    return _scatter(l_i, w, n), _scatter(l_i, L.mont_mul(w, w_dev[r_i]), n)


def _build_phase2_table(eqz, eqb, g, n):
    """F[c] += eq(z, out) * eq(b*, left) at c = right."""
    if g.shape[1] == 0:
        return torch.zeros((n, 16), dtype=L.LIMB_DTYPE, device=eqz.device)
    out_i, l_i, r_i = g
    return _scatter(r_i, L.mont_mul(eqz[out_i], eqb[l_i]), n)


def _unstack_to_host(S: torch.Tensor) -> list[list[int]]:
    """(m, T, 16) stack -> T host int tables."""
    h = S.cpu()
    return [L.unpack(h[:, t]) for t in range(h.shape[1])]


def prove_layer_sumcheck_torch(
    z: list[int],
    w_next: list[int],
    add_gates, mult_gates,
    k_cur: int, k_next: int,
    w_struct: MleStruct,
    transcript: Mimc7,
    w_dev: torch.Tensor | None = None,
    tail_threshold: int = DEVICE_TAIL,
    device="cuda",
):
    """Drop-in replacement for `gkr_tpu_torch.sumcheck.prove_layer_sumcheck`
    running the table math on `device`.  Transcript-identical to the host
    engine (same structural-length and Fiat-Shamir logic).

    Rounds run on the device while the tables are larger than
    `tail_threshold`; the remaining rounds finish on the exact host engine.
    `w_dev` is W_{i+1} already packed on `device` (packed here if None)."""
    k = k_next
    v = 2 * k
    assert v >= 2
    n = 1 << k
    sup = w_struct.support if not w_struct.empty else [False] * k

    if w_dev is None:
        w_dev = L.pack(w_next, device)
    device = w_dev.device
    with record_function("sumcheck.gate_arrays"):
        ga = gate_arrays(add_gates, device)
        gm = gate_arrays(mult_gates, device)
    with record_function("sumcheck.build_phase1"):
        eqz = K.eq_table(L.pack(z, device).reshape(-1, 16))
        ha1, ha2 = _build_phase1_tables(eqz, w_dev, ga, n)
        _, hm = _build_phase1_tables(eqz, w_dev, gm, n)

    proof: list[list[int]] = []
    challenges: list[int] = []
    emit_host = make_emitter(proof, challenges, v, sup, len(add_gates) > 0,
                             len(mult_gates) > 0, transcript)

    def emit_dev(y, j):
        y0, y1, y2 = L.unpack(y)
        emit_host(y0, y1, y2, j)

    # ---- phase 1 ----
    S1 = torch.stack([w_dev, ha1, ha2, hm], dim=1)       # (n, 4, 16)
    del ha1, ha2, hm
    j = 1
    with record_function("sumcheck.phase1_rounds"):
        while j <= k and (n >> (j - 1)) > tail_threshold:
            emit_dev(K.phase1_eval(S1), j)
            S1 = K.fold(S1, L.pack_scalar(challenges[-1], device))
            j += 1
    if j <= k:
        with record_function("sumcheck.phase1_host_tail"):
            W, HA1, HA2, HM = _unstack_to_host(S1)
            W, *_ = phase1_host_rounds(W, HA1, HA2, HM, j, k, emit_host,
                                       challenges)
        wb_int = W[0]
        wb = L.pack_scalar(wb_int, device)
    else:
        wb = S1[0, 0].clone()
        wb_int = L.unpack_scalar(wb)
    del S1

    b_star = challenges[:k]

    # ---- phase 2 ----
    with record_function("sumcheck.build_phase2"):
        eqb = K.eq_table(L.pack(b_star, device))
        fa = _build_phase2_table(eqz, eqb, ga, n)
        fmwb = L.mul_scalar(_build_phase2_table(eqz, eqb, gm, n), wb)
    del eqz, eqb
    S2 = torch.stack([w_dev, fa, fmwb], dim=1)           # (n, 3, 16)
    del fa, fmwb
    j = k + 1
    with record_function("sumcheck.phase2_rounds"):
        while j <= v and (n >> (j - k - 1)) > tail_threshold:
            emit_dev(K.phase2_eval(S2, wb), j)
            S2 = K.fold(S2, L.pack_scalar(challenges[-1], device))
            j += 1
    if j <= v:
        with record_function("sumcheck.phase2_host_tail"):
            Wc, FA, FMwb = _unstack_to_host(S2)
            phase2_host_rounds(Wc, FA, FMwb, wb_int, j, v, emit_host,
                               challenges)

    return proof, challenges
