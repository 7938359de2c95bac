"""Flagship end-to-end cell model: full-slot PDSCH encode (DL) and PUSCH
decode (UL), OFDM included, for one static cell configuration.

Port of ``srsran_project_tpu/models/cell.py``: ``encode_slot`` is the
counterpart of ``encode_slot_fused`` and ``decode_slot`` of
``decode_slot_fused``.  Both take an optional leading slot-batch
dimension (``encode_slots_scan`` / ``decode_slots_scan`` run k chunks of
such a batch where the reference scans), and run on the device of their
input tensor: on a CUDA tensor the UL goes through the hand-written
kernels K1 (LDPC) and K3 (MMSE weights), and with ``demapper="planes"``
K4 (apply + demap into the decoder's bit-planes); on a CPU tensor through
their plain torch versions.
The reference-exact modes (``equalizer="mmse_ref"/"zf_ref"``,
``demapper="reference"``, ``ldpc_decoder="reference_i8"``) run in plain
torch on either device; with ``reference_i8`` the decode takes the
two-stage path into ``decode_i8``, as the reference's fused program does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import ofdm
from ..ops.modulation import Modulation
from ..phy import pdsch, pusch
from ..phy.allocation import Allocation
from ..phy.sch import _desegment_stage, _fused_decode, decode_from_planes, decode_transport_block
from ..ran import tbs as tbs_mod
from ..ran.constants import NRE, CyclicPrefix, SubcarrierSpacing, min_dft_size
from ..support.tracing import l1_tracer


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Static cell parameters; defaults give the 100 MHz / 4x4 flagship.

    Twin of the reference's ``CellConfig``: same fields, defaults and
    derived values.  ``fuse_stages`` chooses how the reference groups its
    compiled TPU programs and does not change results; the eager port has
    no programs to group, so both values run the same code."""

    nof_rb: int = 273
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    cp: CyclicPrefix = CyclicPrefix.NORMAL
    nof_ports: int = 4
    nof_layers: int = 4
    modulation: Modulation = Modulation.QAM256
    target_code_rate: float = 948.0 / 1024.0
    f_center_hz: float = 3.5e9
    sym_start: int = 1
    sym_count: int = 13
    dmrs_symbols: tuple[int, ...] = (2,)
    slot_in_frame: int = 0
    nof_ldpc_iterations: int = 6
    ldpc_early_stop: bool = True
    equalizer: str = "mmse"
    sinr_method: str = "post_equalization"
    cfo_compensation: bool = False
    llr_range_limit: float = 20.0
    demapper: str = "float"
    ldpc_decoder: str = "auto"
    noise_method: str = "second_difference"
    fuse_stages: bool = True

    @classmethod
    def from_reference(cls, ref) -> "CellConfig":
        """Copy a reference (JAX package) ``CellConfig`` field by field, by
        attribute access only; enums convert by value."""
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        kw["scs"] = SubcarrierSpacing(int(kw["scs"]))
        kw["cp"] = CyclicPrefix(int(kw["cp"]))
        kw["modulation"] = Modulation(int(kw["modulation"]))
        kw["dmrs_symbols"] = tuple(kw["dmrs_symbols"])
        return cls(**kw)

    @property
    def dft_size(self) -> int:
        return min_dft_size(self.nof_rb)

    @property
    def nof_sc(self) -> int:
        return self.nof_rb * NRE

    @functools.cached_property
    def alloc(self) -> Allocation:
        return Allocation(rb_start=0, rb_count=self.nof_rb, sym_start=self.sym_start,
                          sym_count=self.sym_count, dmrs_symbols=self.dmrs_symbols)

    @functools.cached_property
    def tbs(self) -> int:
        n_dmrs_re = NRE * len(self.dmrs_symbols)  # type 1, 2 CDM groups w/o data
        return tbs_mod.calculate_tbs(self.nof_rb, self.sym_count, n_dmrs_re,
                                     self.target_code_rate, int(self.modulation),
                                     self.nof_layers)

    @functools.cached_property
    def pdsch_cfg(self) -> pdsch.PdschConfig:
        return pdsch.PdschConfig(
            tbs=self.tbs, target_code_rate=self.target_code_rate,
            modulation=self.modulation, alloc=self.alloc, nof_layers=self.nof_layers,
            nof_ports=self.nof_ports, nof_grid_symbols=14, nof_grid_sc=self.nof_sc,
            slot_in_frame=self.slot_in_frame)

    @functools.cached_property
    def pusch_cfg(self) -> pusch.PuschConfig:
        return pusch.PuschConfig(
            tbs=self.tbs, target_code_rate=self.target_code_rate,
            modulation=self.modulation, alloc=self.alloc, nof_layers=self.nof_layers,
            nof_rx_ports=self.nof_ports, nof_grid_symbols=14, nof_grid_sc=self.nof_sc,
            scs_khz=15 << int(self.scs), slot_in_frame=self.slot_in_frame,
            nof_ldpc_iterations=self.nof_ldpc_iterations,
            ldpc_early_stop=self.ldpc_early_stop, equalizer=self.equalizer,
            sinr_method=self.sinr_method, cfo_compensation=self.cfo_compensation,
            llr_range_limit=self.llr_range_limit, demapper=self.demapper,
            ldpc_decoder=self.ldpc_decoder, noise_method=self.noise_method)


def tiny_cell(nof_rb: int = 6, nof_ports: int = 1) -> CellConfig:
    """A small cell (the reference's compile-check configuration)."""
    return CellConfig(nof_rb=nof_rb, nof_ports=nof_ports, nof_layers=nof_ports,
                      modulation=Modulation.QPSK, target_code_rate=0.3, f_center_hz=0.0)


def _batched(x: torch.Tensor, ndim: int):
    """Add the slot-batch dimension to an unbatched input; returns the
    batched tensor and whether to drop the dimension again."""
    if x.dim() == ndim:
        return x[None], True
    if x.dim() == ndim + 1:
        return x, False
    raise ValueError(f"want {ndim} dims or {ndim + 1} with a leading slot batch, "
                     f"got shape {tuple(x.shape)}")


def _rntis(rnti, batch: int, device: torch.device) -> torch.Tensor:
    r = torch.as_tensor(rnti, dtype=torch.int64, device=device)
    return r.expand(batch) if r.dim() == 0 else r


def encode_slot(tb_bits: torch.Tensor, rnti, precoding: torch.Tensor,
                cfg: CellConfig) -> torch.Tensor:
    """DL slot: TB payload (A,) or (B, A) uint8 -> baseband IQ (P, ns) or
    (B, P, ns) complex64.  rnti: int or (B,) tensor; precoding: (nl, P)."""
    with l1_tracer.span("cell.encode_slot") as span:
        tb, squeeze = _batched(tb_bits, 1)
        span.count(slots=tb.shape[0])
        dev = tb.device
        cw = pdsch._bit_chain(tb, _rntis(rnti, tb.shape[0], dev), cfg.pdsch_cfg)
        grid = pdsch._grid_chain(cw, precoding.to(dev), cfg.pdsch_cfg)
        iq = ofdm.modulate_slot(grid, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                f_center_hz=cfg.f_center_hz)
        return iq[0] if squeeze else iq


def decode_slot(iq: torch.Tensor, rnti, cfg: CellConfig) -> dict:
    """UL slot: IQ (P, ns) or (B, P, ns) complex64 -> {"tb_bits" (..., A)
    uint8, "tb_crc_ok" (...,) bool, "noise_var" (...,), "snr_db" (...,)}.

    New data only: like the reference's fused program, it keeps no HARQ
    buffer, so no rate dematch runs beside the fused K1 decode."""
    with l1_tracer.span("cell.decode_slot") as span:
        x, squeeze = _batched(iq, 2)
        span.count(slots=x.shape[0])
        pc = cfg.pusch_cfg
        grid = ofdm.demodulate_slot(x, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0,
                                    f_center_hz=cfg.f_center_hz)
        rntis = _rntis(rnti, x.shape[0], x.device)
        if pusch._demap_planes_ok(pc):
            planes, noise_var, snr_acc = pusch._front_end_planes(grid, rntis, pc)
            tb, ok = decode_from_planes(planes, pc.sch, pc.nof_ldpc_iterations,
                                        early_stop=pc.ldpc_early_stop)
        else:
            llr_i8, noise_var, snr_acc = pusch._front_end(grid, rntis, pc)
            if pc.sch.decoder == "reference_i8":
                tb, ok, _harq = decode_transport_block(llr_i8, pc.sch, pc.nof_ldpc_iterations,
                                                       early_stop=pc.ldpc_early_stop)
            else:
                bits, _iters = _fused_decode(llr_i8, pc.sch, pc.nof_ldpc_iterations,
                                             pc.ldpc_early_stop)
                tb, ok = _desegment_stage(bits, pc.sch, llr_i8.shape[:-1])
        out = {
            "tb_bits": tb,
            "tb_crc_ok": ok,
            "noise_var": noise_var,
            "snr_db": 10.0 * torch.log10(torch.clamp_min(snr_acc, 1e-12)),
        }
        return {k: v[0] for k, v in out.items()} if squeeze else out


def encode_slots_scan(tb_chunks: torch.Tensor, rnti_chunks, precoding: torch.Tensor,
                      cfg: CellConfig) -> torch.Tensor:
    """k*B DL slots: k chunks, each one batched ``encode_slot`` of B slots
    (the reference's ``lax.scan`` over a vmapped body; the slot batch
    takes the scan's place).

    tb_chunks: (k, B, A) uint8; rnti_chunks: (k, B) integers; precoding:
    (nl, P).  Returns the (k, B) float32 per-slot IQ energy, a checksum of
    every sample, on tb_chunks' device (no host read in the loop)."""
    if tb_chunks.dim() != 3:
        raise ValueError(f"encode_slots_scan: want (k, B, A) TB chunks, got "
                         f"{tuple(tb_chunks.shape)}")
    rntis = torch.as_tensor(rnti_chunks, dtype=torch.int64, device=tb_chunks.device)
    energy = []
    for tb, rnti in zip(tb_chunks, rntis):
        iq = encode_slot(tb, rnti, precoding, cfg)
        energy.append((iq.real ** 2 + iq.imag ** 2).sum(dim=(1, 2)))
    return torch.stack(energy)


def decode_slots_scan(iq_chunks: torch.Tensor, rnti_chunks, tb_expected: torch.Tensor,
                      cfg: CellConfig):
    """k*B UL slot decodes: k chunks, each one batched ``decode_slot`` of
    B slots (twin of ``encode_slots_scan``).

    iq_chunks: (k, B, P, ns) complex64; rnti_chunks: (k, B) integers;
    tb_expected: (A,) uint8, the transmitted payload, compared on the
    device.  Returns (crc_ok (k, B) int32, bit_errors (k, B) int32) on
    iq_chunks' device (no host read in the loop)."""
    if iq_chunks.dim() != 4:
        raise ValueError(f"decode_slots_scan: want (k, B, P, ns) IQ chunks, got "
                         f"{tuple(iq_chunks.shape)}")
    rntis = torch.as_tensor(rnti_chunks, dtype=torch.int64, device=iq_chunks.device)
    tb_expected = tb_expected.to(iq_chunks.device)
    ok, errs = [], []
    for iq, rnti in zip(iq_chunks, rntis):
        out = decode_slot(iq, rnti, cfg)
        ok.append(out["tb_crc_ok"].to(torch.int32))
        errs.append((out["tb_bits"] != tb_expected[None]).sum(dim=1, dtype=torch.int32))
    return torch.stack(ok), torch.stack(errs)
