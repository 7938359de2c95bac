"""Upper PHY state, the part the multi-UE slot needs.

Port of ``HarqBufferPool`` from ``srsran_project_tpu/phy/upper_phy.py``:
soft-bit buffers, as torch tensors on any device, keyed like the
reference's trx_buffer_identifier (rnti, harq id).  ``UpperPhy`` itself is
not ported yet (ROADMAP Q1.10).
"""

from __future__ import annotations

import torch


class HarqBufferPool:
    """Soft-bit buffers keyed by (rnti, harq id): new data resets,
    retransmissions combine inside the PUSCH decoder.  Holds at most
    ``max_buffers``; a new key beyond that evicts the oldest."""

    def __init__(self, max_buffers: int = 64):
        self.max_buffers = max_buffers
        self._buffers: dict[tuple[int, int], torch.Tensor] = {}

    def get(self, rnti: int, harq_id: int) -> torch.Tensor | None:
        return self._buffers.get((rnti, harq_id))

    def put(self, rnti: int, harq_id: int, buf: torch.Tensor) -> None:
        if len(self._buffers) >= self.max_buffers and (rnti, harq_id) not in self._buffers:
            self._buffers.pop(next(iter(self._buffers)))
        self._buffers[(rnti, harq_id)] = buf

    def release(self, rnti: int, harq_id: int) -> None:
        self._buffers.pop((rnti, harq_id), None)
