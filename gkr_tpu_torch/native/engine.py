"""CppBackend: the layer sumcheck on the native host library (libgkrhost).

The twin of the JAX package's `native.engine`.  Transcript-identical to the
pure-Python host engine: the same structural-length rules and Fiat–Shamir
logic (the shared helpers of `..sumcheck`); only the table arithmetic
moves into C++ (OpenMP-parallel, the reference's rayon analog)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..field import P
from ..mimc import Mimc7
from ..mle import MleStruct, SparseMle
from ..prover import HostBackend
from ..sumcheck import make_emitter
from . import lib

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _buf(data: bytearray):
    return ctypes.cast((ctypes.c_uint8 * len(data)).from_buffer(data), _U8P)


def ints_to_buf(vals) -> bytearray:
    return bytearray(b"".join(int(v % P).to_bytes(32, "little")
                              for v in vals))


def buf_to_ints(data: bytearray) -> list[int]:
    return [int.from_bytes(data[i:i + 32], "little")
            for i in range(0, len(data), 32)]


def _gates_arr(gates):
    g = np.asarray(gates, dtype=np.int32).reshape(-1)
    return g, g.ctypes.data_as(_I32P)


def _require():
    """The library, or RuntimeError under GKR_NO_NATIVE=1."""
    L = lib()
    if L is None:
        raise RuntimeError("libgkrhost disabled (GKR_NO_NATIVE=1)")
    return L


class CppBackend(HostBackend):
    """HostBackend with the layer sumcheck and the Möbius transform in
    native code."""

    def __init__(self):
        self.L = _require()

    def sparse_from_dense(self, w_values):
        return sparse_from_dense_native(w_values)

    def layer_sumcheck(self, z, w_next, add_gates, mult_gates,
                       k_cur, k_next, w_struct: MleStruct,
                       transcript: Mimc7, layer_idx=None):
        L = self.L
        k, v = k_next, 2 * k_next
        assert v >= 2
        n = 1 << k
        sup = w_struct.support if not w_struct.empty else [False] * k
        has_add = len(add_gates) > 0
        has_mult = len(mult_gates) > 0

        proof, challenges = [], []
        emit = make_emitter(proof, challenges, v, sup, has_add, has_mult,
                            transcript)

        # Montgomery-domain working buffers
        w_m = ints_to_buf(w_next)
        L.gkr_to_mont(_buf(w_m), n)

        z_m = ints_to_buf(z)
        if z:
            L.gkr_to_mont(_buf(z_m), len(z))
        eqz = bytearray(32 * (1 << len(z)))
        L.gkr_eq_table(_buf(z_m), len(z), _buf(eqz))

        ha1 = bytearray(32 * n)
        ha2 = bytearray(32 * n)
        hm = bytearray(32 * n)
        if add_gates:
            _keep, gp = _gates_arr(add_gates)
            L.gkr_scatter_phase1(_buf(eqz), _buf(w_m), gp, len(add_gates),
                                 _buf(ha1), _buf(ha2))
        if mult_gates:
            _keep2, gp = _gates_arr(mult_gates)
            L.gkr_scatter_phase1(_buf(eqz), _buf(w_m), gp, len(mult_gates),
                                 None, _buf(hm))

        y = bytearray(96)

        def read_y():
            yc = bytearray(y)
            L.gkr_from_mont(_buf(yc), 3)
            return buf_to_ints(yc)

        def mont_scalar(x: int) -> bytearray:
            b = ints_to_buf([x])
            L.gkr_to_mont(_buf(b), 1)
            return b

        # ---- phase 1 ----
        W1 = bytearray(w_m)
        size = n
        for j in range(1, k + 1):
            L.gkr_phase1_eval(_buf(W1), _buf(ha1), _buf(ha2), _buf(hm),
                              size, _buf(y))
            y0, y1, y2 = read_y()
            emit(y0, y1, y2, j)
            r_m = mont_scalar(challenges[-1])
            for t in (W1, ha1, ha2, hm):
                L.gkr_fold(_buf(t), size, _buf(r_m))
            size //= 2

        b_star = challenges[:k]
        wb_m = bytearray(W1[:32])

        # ---- phase 2 ----
        bs_m = ints_to_buf(b_star)
        L.gkr_to_mont(_buf(bs_m), k)
        eqb = bytearray(32 * n)
        L.gkr_eq_table(_buf(bs_m), k, _buf(eqb))
        fa = bytearray(32 * n)
        fmwb = bytearray(32 * n)
        if add_gates:
            _keep3, gp = _gates_arr(add_gates)
            L.gkr_scatter_phase2(_buf(eqz), _buf(eqb), None, gp,
                                 len(add_gates), _buf(fa))
        if mult_gates:
            _keep4, gp = _gates_arr(mult_gates)
            L.gkr_scatter_phase2(_buf(eqz), _buf(eqb), _buf(wb_m), gp,
                                 len(mult_gates), _buf(fmwb))

        Wc = bytearray(w_m)
        size = n
        for j in range(k + 1, v + 1):
            L.gkr_phase2_eval(_buf(Wc), _buf(fa), _buf(fmwb), _buf(wb_m),
                              size, _buf(y))
            y0, y1, y2 = read_y()
            emit(y0, y1, y2, j)
            r_m = mont_scalar(challenges[-1])
            for t in (Wc, fa, fmwb):
                L.gkr_fold(_buf(t), size, _buf(r_m))
            size //= 2

        return proof, challenges


def sparse_from_dense_native(values):
    """Möbius transform in C++ and nonzero compaction in numpy -> lazy
    SparseMle, row for row what the host transform returns.

    The values and the term list both live on the host, so the
    canonical-domain C++ transform needs no copy to a device and back.
    Raises under GKR_NO_NATIVE=1."""
    L = _require()
    n = len(values)
    k = n.bit_length() - 1
    assert n == 1 << k, "table length must be a power of two"
    buf = ints_to_buf(values)
    L.gkr_mobius(_buf(buf), n)
    arr = np.frombuffer(bytes(buf), dtype=np.uint16).reshape(n, 16)
    nz = np.nonzero(arr.any(axis=1))[0]
    return SparseMle(k, nz, arr[nz].astype(np.uint32))


class NativeMimc7:
    """Mimc7 drop-in backed by libgkrhost (same transcripts; MiMC7-91 only,
    the constants the library holds).  Raises under GKR_NO_NATIVE=1."""

    def __init__(self):
        self.L = _require()
        self._py = Mimc7()

    def hash(self, x: int, k: int) -> int:
        return self._py.hash(x, k)

    def multi_hash(self, arr, key: int = 0) -> int:
        if key != 0:
            return self._py.multi_hash(arr, key)
        data = ints_to_buf(arr)
        out = bytearray(32)
        self.L.gkr_mimc_multi_hash(_buf(data), len(arr), _buf(out))
        return int.from_bytes(out, "little")
