"""The native (C++) host library: `csrc/gkrhost.cpp`, loaded with ctypes.

The twin of the JAX package's `native` loader.  The library is built at
first use with g++ and OpenMP (`CXX_FLAGS`, the reference's flags) into
`_build/` beside this package, under a name keyed by a hash of the
source, the flags and the CPU that `-march=native` reads, so a library is
never loaded on a machine it was not built for.  The build runs under a
file lock and lands by an atomic rename, so concurrent processes build it
once; in a process it is built and loaded once, by one thread at a time.

Unlike the reference, a failed build or load raises (with the compiler's
report): nothing falls back to the Python engine quietly.  The one way to
the Python paths is `GKR_NO_NATIVE=1`, as in the reference: `lib()` then
returns None, `mimc.fast_transcript` keeps the Python hash and
`CppBackend()` raises.

The library's OpenMP runtime may be the one torch loaded, in which case
its thread count (`gkr_num_threads()`) follows `torch.set_num_threads`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gkrhost.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
VERSION = 1                      # gkr_version() of the ABI this loader binds

_lib = None
_LOAD_LOCK = threading.Lock()

# Argument types of each entry point: p byte pointer, g int32 pointer,
# n size_t
_SIGNATURES = {
    "gkr_batch_mul": "pppn",
    "gkr_batch_add": "pppn",
    "gkr_mimc_init": "p",
    "gkr_mimc_multi_hash": "pnp",
    "gkr_to_mont": "pn",
    "gkr_from_mont": "pn",
    "gkr_eq_table": "pnp",
    "gkr_scatter_phase1": "ppgnpp",
    "gkr_scatter_phase2": "pppgnp",
    "gkr_phase1_eval": "ppppnp",
    "gkr_phase2_eval": "ppppnp",
    "gkr_fold": "pnp",
    "gkr_mobius": "pn",
}
_CTYPES = {"p": ctypes.POINTER(ctypes.c_uint8),
           "g": ctypes.POINTER(ctypes.c_int32), "n": ctypes.c_size_t}


_CPU_KEYS = ("vendor_id", "cpu family", "model", "model name", "flags")


def _cpu() -> dict[str, str]:
    """The first processor's identity in /proc/cpuinfo (empty where there
    is none): what `-march=native` depends on."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return {}
    info: dict[str, str] = {}
    for line in text.split("\n\n")[0].splitlines():
        key, _, value = line.partition(":")
        if key.strip() in _CPU_KEYS:
            info[key.strip()] = value.strip()
    return info


def cpu_model() -> str:
    """The host CPU: its model name, and its vendor, family and model
    numbers (a virtual machine may report the name as unknown)."""
    info = _cpu()
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model {info.get('model', '?')})")


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    h.update(repr(sorted(_cpu().items())).encode())
    return BUILD_DIR / f"libgkrhost-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library, compiled unless it is already built; raises with the
    compiler's report.  Processes that reach this together build it once:
    the build holds a file lock and renames a finished file into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "gkrhost.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                          # built while we waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                res = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                                     capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"{CXX} could not run: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"{CXX} failed ({res.returncode}) on "
                                   f"{SOURCE.name}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def lib():
    """The loaded library (built at first use), or None under
    GKR_NO_NATIVE=1.  Raises if it cannot be built or loaded."""
    global _lib
    if os.environ.get("GKR_NO_NATIVE", "") == "1":
        return None
    if _lib is None:
        with _LOAD_LOCK:
            if _lib is None:
                _lib = _load_library()
    return _lib


def _load_library():
    L = ctypes.CDLL(str(build()))
    for name, sig in _SIGNATURES.items():
        getattr(L, name).argtypes = [_CTYPES[c] for c in sig]
    L.gkr_version.restype = ctypes.c_int
    L.gkr_num_threads.restype = ctypes.c_int
    if L.gkr_version() != VERSION:
        raise RuntimeError(f"libgkrhost reports ABI version {L.gkr_version()}, "
                           f"not {VERSION}")
    # the MiMC7-91 round constants, from the port's own Keccak chain
    from ..mimc import mimc7_constants
    cts = b"".join(c.to_bytes(32, "little") for c in mimc7_constants())
    buf = (ctypes.c_uint8 * len(cts)).from_buffer_copy(cts)
    L.gkr_mimc_init(ctypes.cast(buf, _CTYPES["p"]))
    return L
