"""The torch/CUDA device engine: limb arithmetic (`limbs`), the CUDA
kernels and their plain versions (`kernels`), the per-round layer sumcheck
(`sumcheck`) and the prover backend (`backend`)."""
