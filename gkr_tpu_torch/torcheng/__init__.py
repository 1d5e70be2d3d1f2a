"""The torch/CUDA device engine: limb arithmetic (`limbs`), the CUDA
kernels and their plain versions (`kernels`), the fused layer sumcheck
(`fused`, the default), the per-round layer sumcheck (`sumcheck`) and the
prover backend (`backend`)."""
