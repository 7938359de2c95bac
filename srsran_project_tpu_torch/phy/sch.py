"""Shared-channel transport coding: TB bits <-> codeword bits / LLRs.

Port of ``srsran_project_tpu/phy/sch.py``: the encoder chain (segment +
CRC, LDPC encode with LBRM-truncated parity, per-E-group rate match), the
fused decode (one K1 launch over every E-group, then desegment + CRC),
its plane-layout twin ``decode_from_planes``, and the two-stage decode for
HARQ retransmissions and repetition geometry (rate dematch + HARQ
combine, then one K2 launch), and the reference-exact int8 mode
(``decoder="reference_i8"``: the two-stage dematch, then ``decode_i8``
with the reference's CRC-gated two-phase early stop).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.ldpc import encoder as ldpc_encoder
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc import segmenter
from ..ops import crc as crc_mod
from ..ops.ldpc.decoder import decode, decode_dematch_groups, decode_i8
from ..support.tracing import l1_tracer

# LDPC decoder selections: "auto" runs K1 / K2 (the plain torch versions on
# the CPU), "reference_i8" the reference-exact int8 min-sum in torch.
DECODERS = ("auto", "reference_i8")


@dataclasses.dataclass(frozen=True)
class SchConfig:
    """Static transport-block coding configuration (twin of the
    reference's ``SchConfig``: same fields, defaults and derived values)."""

    tbs: int
    target_code_rate: float
    qm: int
    nof_layers: int
    nof_total_bits: int  # G: rate-matched bits of this codeword
    rv: int = 0
    # TBS_LBRM for limited-buffer rate matching; None = unlimited buffer.
    tbs_lbrm_bytes: int | None = 159749
    decoder: str = "auto"

    def __post_init__(self):
        if self.decoder not in DECODERS:
            raise ValueError(f"SchConfig.decoder={self.decoder!r}: want one of {DECODERS}")

    @functools.cached_property
    def seg(self) -> segmenter.SegmentParams:
        return segmenter.compute_segment_params(self.tbs, self.target_code_rate)

    @functools.cached_property
    def n_cb(self) -> int | None:
        """Circular-buffer length min(N, N_ref); None = full N."""
        if self.tbs_lbrm_bytes is None:
            return None
        n = self.seg.full_codeword_bits
        n_ref = min(self.tbs_lbrm_bytes * 8 * 3 // (2 * self.seg.nof_codeblocks), 25344)
        return n_ref if n_ref < n else None

    @functools.cached_property
    def cb_e_bits(self) -> tuple[int, ...]:
        """Per-codeblock rate-matched length E_r (TS 38.212 §5.4.2.1)."""
        c = self.seg.nof_codeblocks
        g = self.nof_total_bits
        unit = self.qm * self.nof_layers
        assert g % unit == 0, (g, unit)
        lo = unit * (g // (unit * c))
        nof_hi = (g // unit) % c
        return tuple([lo] * (c - nof_hi) + [lo + unit] * nof_hi)


def _e_groups(cb_e_bits):
    """Codeblocks grouped by equal E: [(start, count, e)], contiguous."""
    groups = []
    start = 0
    for e in cb_e_bits:
        if groups and groups[-1][2] == e:
            s, c, _ = groups[-1]
            groups[-1] = (s, c + 1, e)
        else:
            groups.append((start, 1, e))
        start += 1
    return groups


def encode_transport_block(tb_bits: torch.Tensor, cfg: SchConfig) -> torch.Tensor:
    """TB payload (..., A) -> codeword bits (..., G)."""
    seg = cfg.seg
    cbs = segmenter.segment_tx(tb_bits, seg)  # (..., C, K)
    buf = ldpc_encoder.encode_to_buffer(cbs, seg.base_graph, seg.lifting_size, n_cb=cfg.n_cb)
    pieces = []
    for start, count, e in _e_groups(cfg.cb_e_bits):
        grp = rm.rate_match(buf[..., start : start + count, :], seg.base_graph,
                            seg.lifting_size, seg.nof_payload_bits_per_cb, e, cfg.rv,
                            cfg.qm, cfg.n_cb)  # (..., count, e)
        pieces.append(grp.reshape(grp.shape[:-2] + (count * e,)))
    return torch.cat(pieces, dim=-1)


@functools.lru_cache(maxsize=None)
def _fused_decode_ok(cfg: SchConfig) -> bool:
    """The fused dematch + decode covers the no-repetition case (every E_r
    fits one pass over the usable circular buffer)."""
    seg = cfg.seg
    n_cb = cfg.n_cb or seg.full_codeword_bits
    usable = sum(ln for _, ln in rm._valid_runs(
        seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, cfg.rv, n_cb))
    return max(cfg.cb_e_bits) <= usable


def _decode_groups(llrs: torch.Tensor, cfg: SchConfig, nof_iterations: int,
                   early_stop: bool):
    """One ``decode_dematch_groups`` call over every E-group (the
    de-stream -> buffer map is E-specific): (B, G) stream or (B, qm, G/qm)
    planes -> (bits (B*C, K) uint8, iterations (B*C,) int32)."""
    seg = cfg.seg
    return decode_dematch_groups(
        llrs, tuple((count, e) for _start, count, e in _e_groups(cfg.cb_e_bits)),
        seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, cfg.rv, cfg.qm,
        cfg.n_cb or seg.full_codeword_bits, nof_iterations, early_stop=early_stop)


def _fused_decode(llrs: torch.Tensor, cfg: SchConfig, nof_iterations: int, early_stop: bool):
    """Rate dematch + LDPC decode of every E-group in one K1 launch, reading
    the LLRs in place.  llrs (..., G) int8 -> (bits (lead*C, K) uint8,
    iterations (lead*C,) int32), rows ordered as the reference's."""
    return _decode_groups(llrs.reshape(-1, llrs.shape[-1]), cfg, nof_iterations, early_stop)


def _desegment_stage(bits: torch.Tensor, cfg: SchConfig, lead_shape: tuple):
    """(lead*C, K) codeblock bits -> (TB (lead..., A), CRC ok (lead...,))."""
    with l1_tracer.span("sch.desegment"):
        seg = cfg.seg
        return segmenter.desegment_rx(
            bits.reshape(tuple(lead_shape) + (seg.nof_codeblocks, -1)), seg)


def _dematch_stage(llrs: torch.Tensor, harq_buffer, cfg: SchConfig) -> torch.Tensor:
    """Rate dematch per E-group, then the HARQ combine when a buffer is
    given: (..., G) int8 LLRs -> the new (..., C, N) int8 HARQ buffer, which
    is also the two-stage decoder's input."""
    with l1_tracer.span("sch.dematch"):
        seg = cfg.seg
        dematched = []
        off = 0
        for _start, count, e in _e_groups(cfg.cb_e_bits):
            span = llrs[..., off : off + count * e]
            dematched.append(rm.rate_dematch(
                span.reshape(span.shape[:-1] + (count, e)), seg.base_graph, seg.lifting_size,
                seg.nof_payload_bits_per_cb, e, cfg.rv, cfg.qm, cfg.n_cb))
            off += count * e
        buf = torch.cat(dematched, dim=-2)
        if harq_buffer is not None:
            buf = rm.combine_harq(harq_buffer, buf)
        return buf


def _decode_i8_stage(buf: torch.Tensor, cfg: SchConfig, nof_iterations: int,
                     early_stop: bool) -> torch.Tensor:
    """The reference-exact int8 decode of (..., C, N) codeword buffers ->
    (lead*C, K) bits.  With early stop (and a budget above 2), the
    reference's CRC-gated two-phase decode: 2 iterations, and the whole
    budget when any codeblock's CRC fails.  This is the reference's CPU
    branch; its TPU branch runs the whole budget (ROADMAP Q3)."""
    seg = cfg.seg
    flat = buf.reshape((-1,) + buf.shape[-1:])

    def run(iters):
        return decode_i8(flat, seg.base_graph, seg.lifting_size, iters)[0]

    if not (early_stop and nof_iterations > 2):
        return run(nof_iterations)
    bits = run(2)
    crc_name = "24B" if seg.nof_codeblocks > 1 else seg.tb_crc
    if bool(crc_mod.crc(bits[:, : seg.nof_payload_bits_per_cb], crc_name).any()):
        bits = run(nof_iterations)
    return bits


def decode_transport_block(llrs: torch.Tensor, cfg: SchConfig, nof_iterations: int = 6,
                           harq_buffer: torch.Tensor | None = None,
                           early_stop: bool = False):
    """Codeword LLRs (..., G) int8 -> (tb_bits (..., A) uint8,
    tb_crc_ok (...,) bool, new HARQ buffer (..., C, N) int8).

    harq_buffer holds the combined buffer LLRs of earlier transmissions
    (None for new data).  New data without repetition decodes through the
    fused K1 path and still returns its buffer; a retransmission or a
    repetition geometry takes the two-stage path: dematch + combine, then
    one K2 launch over every codeblock.  ``decoder="reference_i8"`` always
    takes the two-stage path, into ``decode_i8``."""
    if llrs.dtype != torch.int8:
        raise ValueError(f"decode_transport_block: want int8 LLRs, got {llrs.dtype}")
    new_harq = _dematch_stage(llrs, harq_buffer, cfg)
    if cfg.decoder == "reference_i8":
        bits = _decode_i8_stage(new_harq, cfg, nof_iterations, early_stop)
    elif harq_buffer is None and _fused_decode_ok(cfg):
        bits, _iters = _fused_decode(llrs, cfg, nof_iterations, early_stop)
    else:
        seg = cfg.seg
        bits = decode(new_harq.reshape((-1,) + new_harq.shape[-1:]), seg.base_graph,
                      seg.lifting_size, nof_iterations, early_stop=early_stop,
                      bits_only=True, n_cb=cfg.n_cb)[0]
    tb, ok = _desegment_stage(bits, cfg, llrs.shape[:-1])
    return tb, ok, new_harq


def decode_from_planes(planes: torch.Tensor, cfg: SchConfig, nof_iterations: int = 6,
                       early_stop: bool = False):
    """Decode straight from (B, qm, G/qm) de-interleave bit-planes (the
    output of ``pusch._front_end_planes``): each E-group's codeblocks are a
    strided view of the planes, and one K1 launch reads them all in place.
    New data without repetition only (no HARQ buffer).  Returns
    (tb_bits (B, A), tb_crc_ok (B,))."""
    bits, _iters = _decode_groups(planes, cfg, nof_iterations, early_stop)
    return _desegment_stage(bits, cfg, (planes.shape[0],))
