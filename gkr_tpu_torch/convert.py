"""Carry state across from the JAX package without importing it.

`gkr_tpu`'s device limbs (`np.asarray(L.pack(xs))`, uint32 (..., 16)) and
this package's int32 limb tensors hold the same 16-bit Montgomery limbs, so
conversion is a dtype change; circuits convert by their attributes."""

from __future__ import annotations

import numpy as np
import torch

from .circuit import GateLayer, GKRCircuit


def limbs_from_numpy(a) -> torch.Tensor:
    """(..., 16) uint32 numpy limbs -> the port's int32 limb tensor (CPU)."""
    a = np.asarray(a)
    if a.shape[-1] != 16 or a.size and int(a.max()) > 0xFFFF:
        raise ValueError("expected (..., 16) limbs of 16 bits")
    return torch.from_numpy(a.astype(np.int32))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's limb tensor -> (..., 16) uint32 numpy limbs."""
    return t.detach().cpu().numpy().astype(np.uint32)


def circuit_from(c) -> GKRCircuit:
    """A port circuit from any object with `.layers[i].k_cur / .k_next /
    .add_gates / .mult_gates` and `.input_k` (such as a `gkr_tpu`
    GKRCircuit)."""
    layers = [GateLayer(l.k_cur, l.k_next,
                        [tuple(g) for g in l.add_gates],
                        [tuple(g) for g in l.mult_gates])
              for l in c.layers]
    return GKRCircuit(layers=layers, input_k=c.input_k)
