"""Spans the benchmark records around its calls into the program.

A span has a name, the request it belongs to, and its host-clock seconds;
on a traced run it is also a `torch.profiler` range of the same name, so
the device trace can say what the host was doing while the card idled.
Untraced runs record nothing."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.request = -1                     # the request being served
        self.seconds: dict[str, list[tuple[int, float]]] = defaultdict(list)

    @contextmanager
    def span(self, name: str, sync=None):
        """Time the block; `sync()` runs at its end, inside the span (a
        device synchronize, so that the span holds the device work)."""
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        with record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            yield
            if sync is not None:
                sync()
            self.seconds[name].append((self.request, time.perf_counter() - t0))

    def marker(self, name: str):
        """A profiler range with no timing (a no-op when untraced)."""
        if not self.enabled:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(f"bench.{name}")

    def per_request(self, name: str) -> list[float]:
        """The span's seconds summed by request, one entry a request that
        has it."""
        by = defaultdict(float)
        for req, s in self.seconds.get(name, ()):
            by[req] += s
        return list(by.values())


def traced_backend(spans: Spans, **kw):
    """The program's `TorchBackend` with its pass-1 upload (`packed`) and
    its sparse forms (`sparse_from_dense`) timed, each ending in a device
    synchronize.  Used only on traced runs."""
    import torch
    from gkr_tpu_torch.torcheng.backend import TorchBackend

    def sync():
        torch.cuda.synchronize()

    class SpannedBackend(TorchBackend):
        def packed(self, layer_idx, w_values):
            with spans.span("pack", sync if self.device.type == "cuda" else None):
                return super().packed(layer_idx, w_values)

        def sparse_from_dense(self, w_values):
            with spans.span("sparse_form", sync if self.device.type == "cuda" else None):
                return super().sparse_from_dense(w_values)

    return SpannedBackend(**kw)
