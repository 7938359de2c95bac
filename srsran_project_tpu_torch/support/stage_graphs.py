"""CUDA graphs of a slot's stages, replayed inside their spans.

The downlink FAPI entry (``phy/upper_phy.UpperPhy``) runs each stage of a
slot through ``StageGraphs.run``: a PDSCH batch's bit chain and its grid
chain, the request's PDCCH, its SSBs, its CSI-RS.  A stage is a function
of device tensors that writes into the entry's slot grid or returns a
tensor; its key names everything else it reads (configurations,
placements, the grid it writes).

On a CUDA device a graph is tied to the memory it reads: the key joins the
address, shape, strides and dtype of every input.  The first call of such
a key runs the function eagerly, which builds every host plan and device
table it reads; the second captures it as a CUDA graph and replays it;
every later call replays it, inside a span of the name and counts the
stage's own spans give, so the tracer still sees each stage.  The inputs
are at the same addresses call after call where they come from
``upload`` (an arena kept per layout of the payloads) or from another
stage's graph (its output tensor, valid until that key's next replay).
An input anywhere else makes a new key at each call, and the stage runs
eagerly.  On any other device every call runs the function.
"""

from __future__ import annotations

import numpy as np
import torch

from .tracing import l1_tracer

_ALIGN = 16  # bytes between the start of two arena parts


class _Arena:
    """One page-locked host buffer and its device copy, cut into typed
    views of one layout of parts."""

    def __init__(self, layout: tuple, device: torch.device):
        offsets, end = [], 0
        for shape, dtype in layout:
            offsets.append(end)
            end += -(-int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
                     // _ALIGN) * _ALIGN
        self.host = torch.empty(max(end, _ALIGN), dtype=torch.uint8, pin_memory=True)
        self.dev = torch.empty(max(end, _ALIGN), dtype=torch.uint8, device=device)
        raw = self.host.numpy()
        self.host_views, self.dev_views = [], []
        for off, (shape, dtype) in zip(offsets, layout):
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            self.host_views.append(raw[off : off + n].view(dtype).reshape(shape))
            self.dev_views.append(self.dev[off : off + n].view(_TORCH[np.dtype(dtype)])
                                  .reshape(shape))
        self.copied = torch.cuda.Event()
        self.copied.record()


def _tensor(src, dtype, device: torch.device) -> torch.Tensor:
    """A part as a new tensor on the device (tensors in it stay where
    they are until stacked there)."""
    dt = _TORCH[np.dtype(dtype)]
    if isinstance(src, list):
        return torch.stack([torch.as_tensor(x, dtype=dt, device=device) for x in src])
    return torch.as_tensor(src, dtype=dt, device=device)


_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int64): torch.int64,
          np.dtype(np.complex64): torch.complex64}


class StageGraphs:
    """The captured stages of one slot entry, keyed as ``run`` says; when
    ``max_graphs`` are kept, they are all dropped and captured anew."""

    def __init__(self, device: torch.device | str, max_graphs: int = 256):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self.max_graphs = max_graphs
        self._seen: set = set()
        self._graphs: dict = {}
        self._arenas: dict = {}

    def upload(self, parts: list) -> list:
        """Request payloads as device tensors, one a part: ``(source,
        numpy dtype)``, the source an array or a list of equal-shape arrays
        (or numbers) stacked on a new first axis.  Where graphs replay, every
        part goes through one page-locked buffer and one copy into the
        arena of their layout, which the next call with that layout
        overwrites (after this one's copy has left the host buffer)."""
        held = [isinstance(src, torch.Tensor)
                or (isinstance(src, list) and any(isinstance(x, torch.Tensor) for x in src))
                for src, _ in parts]
        if not self.enabled or any(held):
            return [_tensor(src, dt, self.device) for src, dt in parts]
        layout = tuple(((len(src),) + np.shape(src[0]) if isinstance(src, list)
                        else np.shape(src), dt) for src, dt in parts)
        arena = self._arenas.get(layout)
        if arena is None:
            if len(self._arenas) >= self.max_graphs:
                self._arenas.clear()
            arena = self._arenas[layout] = _Arena(layout, self.device)
        arena.copied.synchronize()
        for (src, _), view in zip(parts, arena.host_views):
            if isinstance(src, list):
                for i, row in enumerate(src):
                    view[i] = row
            else:
                view[...] = src
        arena.dev.copy_(arena.host, non_blocking=True)
        arena.copied.record()
        return arena.dev_views

    def run(self, span: str, counts: dict, key, fn, *inputs: torch.Tensor):
        """``fn(*inputs)``, eagerly or by the graph of the key and the
        inputs' memory, as the module says (``span`` and ``counts`` name
        the replay)."""
        if not self.enabled:
            return fn(*inputs)
        key = (key,) + tuple((x.data_ptr(), x.shape, x.stride(), x.dtype) for x in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                if len(self._seen) >= self.max_graphs:
                    self._seen.clear()
                self._seen.add(key)
                return fn(*inputs)
            self._seen.discard(key)
            if len(self._graphs) >= self.max_graphs:
                self._graphs.clear()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*inputs)
            # The inputs are kept with the graph, so that their memory
            # stays theirs while the graph reads it.
            entry = self._graphs[key] = (graph, out, inputs)
        graph, out, _ = entry
        with l1_tracer.span(span) as s:
            s.count(**counts)
            graph.replay()
        return out
