"""Transport-block segmentation for LDPC-coded SCH (TS 38.212 §5.2.2).

Port of ``srsran_project_tpu/ops/ldpc/segmenter.py``: the geometry is a
static host description (``SegmentParams``, field for field the
reference's), and CRC attach / filler insertion / desegmentation are
batched tensor code.
"""

from __future__ import annotations

import dataclasses

import torch

from . import graphs

from .. import crc as crc_mod

MAX_SEG_BITS = {graphs.BG1: 8448, graphs.BG2: 3840}
CB_CRC_BITS = 24


def tb_crc_name(tbs: int) -> str:
    """TB-level CRC: 24A above 3824 bits, else 16 (TS 38.212 §7.2.1)."""
    return "24A" if tbs > 3824 else "16"


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    """Static segmentation geometry for one transport block configuration."""

    tbs: int  # A: TB payload bits (no CRC)
    base_graph: int
    nof_codeblocks: int  # C
    lifting_size: int  # Z
    nof_cb_bits: int  # K = K_b * Z
    nof_payload_bits_per_cb: int  # K': info + CRC bits per codeblock
    nof_filler_bits: int  # F = K - K'
    zero_pad: int  # zeros after the TB CRC in the last segment
    tb_crc: str

    @property
    def full_codeword_bits(self) -> int:
        return graphs.get_graph(self.base_graph, self.lifting_size).nof_codeword_bits


def compute_segment_params(tbs: int, target_code_rate: float) -> SegmentParams:
    return compute_segment_params_bg(tbs, graphs.select_base_graph(tbs, target_code_rate))


def compute_segment_params_bg(tbs: int, base_graph: int) -> SegmentParams:
    """Segmentation geometry for an explicitly selected base graph."""
    bg = base_graph
    crc_name = tb_crc_name(tbs)
    b = tbs + crc_mod.POLYS[crc_name][1]
    k_cb = MAX_SEG_BITS[bg]
    c = 1 if b <= k_cb else -(-b // (k_cb - CB_CRC_BITS))
    # B' = B + C*24 (C > 1); K' = ceil(B'/C); the ceil split's shortfall is
    # zero-padded after the TB CRC in the last segment.
    b_prime = b + (CB_CRC_BITS * c if c > 1 else 0)
    k_prime = -(-b_prime // c)
    z = graphs.select_lifting_size(bg, b, c)
    k = graphs.get_graph(bg, z).kb * z
    return SegmentParams(
        tbs=tbs,
        base_graph=bg,
        nof_codeblocks=c,
        lifting_size=z,
        nof_cb_bits=k,
        nof_payload_bits_per_cb=k_prime,
        nof_filler_bits=k - k_prime,
        zero_pad=k_prime * c - b_prime,
        tb_crc=crc_name,
    )


def rate_matched_length(params: SegmentParams, cb_index: int, qm: int, nof_layers: int,
                        nof_ch_symbols: int) -> int:
    """Rate-matched length E_j of segment ``cb_index`` (TS 38.212 §5.4.2.1;
    the reference's ldpc_segmenter_helpers.h compute_rm_length).
    ``nof_ch_symbols`` counts channel symbols over all layers."""
    c = params.nof_codeblocks
    symbols_per_layer = nof_ch_symbols // nof_layers
    if cb_index < c - (symbols_per_layer % c):
        tmp = symbols_per_layer // c
    else:
        tmp = -(-symbols_per_layer // c)
    return tmp * nof_layers * qm


def segment_tx(tb_bits: torch.Tensor, params: SegmentParams) -> torch.Tensor:
    """TB payload bits (..., A) -> (..., C, K) encoder-ready codeblocks:
    TB CRC, C equal segments, a CRC24B per segment when C > 1, and F
    zero filler bits."""
    with_crc = crc_mod.crc_append(tb_bits, params.tb_crc)
    if params.zero_pad:
        with_crc = torch.nn.functional.pad(with_crc, (0, params.zero_pad))
    c = params.nof_codeblocks
    segs = with_crc.reshape(with_crc.shape[:-1] + (c, with_crc.shape[-1] // c))
    if c > 1:
        segs = crc_mod.crc_append(segs, "24B")
    return torch.nn.functional.pad(segs, (0, params.nof_filler_bits))


def desegment_rx(cb_bits: torch.Tensor, params: SegmentParams):
    """(..., C, K) decoded codeblock bits -> ((..., A) TB payload uint8,
    (...,) bool: every CB CRC and the TB CRC pass)."""
    c = params.nof_codeblocks
    k_prime = params.nof_payload_bits_per_cb
    payload = cb_bits[..., :k_prime]
    if c > 1:
        nof_bad = crc_mod.crc(payload, "24B").to(torch.int32).sum(dim=(-2, -1))
        payload = payload[..., : k_prime - CB_CRC_BITS]
        # TB CRC straight from the per-CB payload chunks; the trailing
        # zero_pad of the stream leaves the verdict unchanged.
        tb_ok = crc_mod.crc_check_concat(payload, params.tb_crc)
        nof_bad = nof_bad + (~tb_ok).to(torch.int32)
        tb_with_crc = payload.reshape(payload.shape[:-2] + (-1,))
        tb_with_crc = tb_with_crc[..., : tb_with_crc.shape[-1] - params.zero_pad]
    else:
        tb_with_crc = payload.reshape(payload.shape[:-2] + (-1,))
        tb_with_crc = tb_with_crc[..., : tb_with_crc.shape[-1] - params.zero_pad]
        nof_bad = crc_mod.crc(tb_with_crc, params.tb_crc).to(torch.int32).sum(dim=-1)
    l_tb = crc_mod.POLYS[params.tb_crc][1]
    return tb_with_crc[..., : tb_with_crc.shape[-1] - l_tb], nof_bad == 0
