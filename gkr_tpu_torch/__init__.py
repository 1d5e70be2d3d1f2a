"""gkr_tpu_torch — the GKR prover of `gkr_tpu`, ported to PyTorch and CUDA.

The same protocol, transcripts and proof format as `gkr_tpu`, with the
device engine rewritten for one NVIDIA H100: the layer sumcheck's tables
live in torch tensors on the card and its Montgomery arithmetic runs in
hand-written CUDA kernels (`torcheng/`, `csrc/`).  The host modules
(field, MiMC, MLE, circuit, proof, prover, verifier) and the entry points
(`frontend/`: R1CS and witness files and their compiler to GKR circuits;
`recursion/`: native and circom-path aggregation; `cli`, run as
`python -m gkr_tpu_torch`) are this package's own copies; it imports
neither `jax` nor `gkr_tpu`.
"""

from .circuit import GateLayer, GKRCircuit, get_k
from .field import P
from .mimc import EthsnarksMimc, Mimc7
from .proof import Proof
from .prover import HostBackend, prove, prove_from_input
from .torcheng.backend import TorchBackend, prove_pipelined
from .verifier import VerifyError, verify

__all__ = [
    "GateLayer", "GKRCircuit", "get_k", "P", "Mimc7", "EthsnarksMimc",
    "Proof", "prove", "prove_from_input", "verify", "VerifyError",
    "HostBackend", "TorchBackend", "prove_pipelined",
]

__version__ = "0.1.0"
