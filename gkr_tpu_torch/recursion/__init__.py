from .aggregator import prove_all  # noqa: F401
from .serialize import CircomInputProof, get_meta, modify_proof_for_circom  # noqa: F401
