"""MiMC7 (exponent-7 MiMC, 91 rounds) — the reference's Fiat–Shamir transcript
hash.

Production scheme: the iden3 / circomlib construction, identical to the
`mimc-rs` crate used by the reference prover (rust/src/gkr/sumcheck.rs:45,
`Mimc7::new(91)` + `multi_hash(coeffs, key=Fr::from(0))`) and to circomlib's
`MiMC7`/`MultiMiMC7` templates used by the in-circuit verifier side:

  constants: cts[0] = 0; c_0 = Keccak256("mimc");
             c_{i} = Keccak256(minimal_be_bytes(c_{i-1})), cts[i] = c_i mod p
  hash(x, k): h = undefined
              round i: t = x + k           (i == 0)
                       t = h + k + cts[i]  (i > 0)
              h = t^7 mod p
              return (h + k) mod p
  multi_hash(arr, key): r = key
                        for x in arr: r = (r + x + hash(x, r)) mod p
                        return r   (Miyaguchi–Preneel)

An `EthsnarksMimc` variant reproduces the Python prototype's
`ethsnarks.mimc.mimc_hash` (python/sumcheck.py:4): its constant chain starts
one Keccak deeper, uses fixed 32-byte big-endian encoding, and adds a round
constant in round 0 as well — so the two reference trees do NOT produce
identical transcripts.  The production transcript of this framework follows
the Rust/circom (iden3) scheme.
"""

from __future__ import annotations

import threading
from functools import lru_cache

from .field import P
from .keccak import keccak256, keccak256_int

SEED = b"mimc"
DEFAULT_ROUNDS = 91


def _minimal_be_bytes(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


@lru_cache(maxsize=None)
def mimc7_constants(n_rounds: int = DEFAULT_ROUNDS) -> tuple[int, ...]:
    """iden3 constant chain (go-iden3-crypto mimc7.getConstants)."""
    cts = [0]
    c = keccak256_int(SEED)
    for _ in range(1, n_rounds):
        c = keccak256_int(_minimal_be_bytes(c))
        cts.append(c % P)
    return tuple(cts)


class Mimc7:
    """iden3-compatible MiMC7 over BN254 Fr."""

    def __init__(self, n_rounds: int = DEFAULT_ROUNDS) -> None:
        self.n_rounds = n_rounds
        self.cts = mimc7_constants(n_rounds)

    def hash(self, x: int, k: int) -> int:
        h = 0
        for i in range(self.n_rounds):
            if i == 0:
                t = (x + k) % P
            else:
                t = (h + k + self.cts[i]) % P
            h = pow(t, 7, P)
        return (h + k) % P

    def multi_hash(self, arr: list[int], key: int = 0) -> int:
        r = key % P
        for x in arr:
            x = x % P
            r = (r + x + self.hash(x, r)) % P
        return r


_FAST_MIMC: list = []
_FAST_MIMC_LOCK = threading.Lock()


def fast_transcript(transcript: "Mimc7"):
    """The native MiMC7-91 (`native.engine.NativeMimc7`, the same
    transcripts) for host-side transcript hashing: the re-hash of every
    round in verification and in the device engines' host checks.

    Swapped only for an exact `Mimc7` (not a subclass: tests model forged
    challenge schedules with them) of 91 rounds (the library's constant
    table is MiMC7-91's); any other transcript is returned as given, as it
    is under GKR_NO_NATIVE=1.  A library that fails to build raises."""
    if type(transcript) is not Mimc7 or transcript.n_rounds != DEFAULT_ROUNDS:
        return transcript
    from .native import lib
    if lib() is None:
        return transcript
    if not _FAST_MIMC:
        with _FAST_MIMC_LOCK:
            if not _FAST_MIMC:
                from .native.engine import NativeMimc7
                _FAST_MIMC.append(NativeMimc7())
    return _FAST_MIMC[0]


@lru_cache(maxsize=None)
def _ethsnarks_constants(n_rounds: int = DEFAULT_ROUNDS) -> tuple[int, ...]:
    def H(v: int) -> int:
        return int.from_bytes(keccak256(v.to_bytes(32, "big")), "big")

    seed = int.from_bytes(keccak256(SEED), "big")
    cts = []
    for _ in range(n_rounds):
        seed = H(seed)
        cts.append(seed % P)
    return tuple(cts)


class EthsnarksMimc:
    """ethsnarks.mimc-compatible variant (Python-prototype transcript mode)."""

    def __init__(self, n_rounds: int = DEFAULT_ROUNDS) -> None:
        self.n_rounds = n_rounds
        self.cts = _ethsnarks_constants(n_rounds)

    def hash(self, x: int, k: int) -> int:
        for c in self.cts:
            x = pow((x + k + c) % P, 7, P)
        return (x + k) % P

    def multi_hash(self, arr: list[int], key: int = 0) -> int:
        r = key % P
        for x in arr:
            x = x % P
            r = (r + x + self.hash(x, r)) % P
        return r
