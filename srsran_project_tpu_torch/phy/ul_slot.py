"""Heterogeneous multi-UE uplink slot, and the PUCCH of a slot.

Port of ``srsran_project_tpu/phy/ul_slot.py``: one slot carries PUSCH
grants of different MCS, widths and layer counts (ranks 1-4, MMSE or ZF),
each with an optional HARQ buffer and UCI on PUSCH.  Grants are grouped
by their compact window config; each group runs one batched front end,
one UCI demultiplex + decode (HARQ-ACK, CSI parts 1 and 2; the punctured
ACK positions read 0 in the data stream) and one rate dematch + HARQ
combine, and the LDPC decode batches every group's codeblocks per (base
graph, Z, iterations, early stop, n_cb) into ONE launch of kernel K2.
Then desegment + CRC per group, and the results scatter back to input
order.  Any allocation shape and waveform of ``pusch`` runs here (data on
the DM-RS symbols, DM-RS type 2, PT-RS, DFT-s-OFDM), with each grant's
own CFO compensation and TA; two-step CSI grants are sent away with
ValueError, as the reference's slot does.  ``detect_pucch`` is the port's
one map from a PUCCH format to its detector, for ``process_slot`` and
``UpperPhy.process_ul_tti`` alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.ldpc.decoder import decode
from ..support.tracing import l1_tracer
from . import pucch as pucch_mod
from . import pucch_f2 as f2_mod
from . import pusch as pusch_mod
from .pusch import PuschConfig
from .sch import _dematch_stage, _desegment_stage


@dataclasses.dataclass
class UlSlotPdu:
    """One PUSCH grant of the heterogeneous slot."""

    rnti: int
    first_rb: int
    config: PuschConfig  # compact window config (rb_start=0)
    harq_buffer: torch.Tensor | None = None  # (C, N) int8 for retransmissions

    @classmethod
    def from_reference(cls, ref, device: torch.device | str = "cuda") -> "UlSlotPdu":
        """Copy a reference (JAX package) ``UlSlotPdu``: its config through
        ``PuschConfig.from_reference``, its HARQ buffer (numpy or JAX
        array) as an int8 tensor on ``device``."""
        buf = ref.harq_buffer
        if buf is not None:
            buf = torch.from_numpy(np.array(buf, dtype=np.int8)).to(device)
        return cls(rnti=int(ref.rnti), first_rb=int(ref.first_rb),
                   config=PuschConfig.from_reference(ref.config), harq_buffer=buf)


def _slot_front(grid: torch.Tensor, groups: dict, pdus: list):
    """Per config group: batched front end + UCI demultiplex and decode +
    rate dematch + HARQ combine.  Returns per group (codeword buffers (Ni,
    C, N) int8, noise_var (Ni,), SINR (Ni,), dict of the other result keys
    stacked over the group: the UCI ones, and "ta_s" with compute_ta)."""
    dev = grid.device
    outs = []
    for cfg, idxs in groups.items():
        first_rbs = tuple(int(pdus[i].first_rb) for i in idxs)
        rntis = torch.tensor([int(pdus[i].rnti) for i in idxs], dtype=torch.int64, device=dev)
        llrs, nvs, snrs, *ta = pusch_mod._multi_front_end(
            grid, rntis, [12 * r for r in first_rbs], pusch_mod._pilot_bank_on(dev, cfg, first_rbs),
            cfg)
        data, extra = pusch_mod.split_uci(llrs, cfg)
        if ta:
            extra["ta_s"] = ta[0]
        outs.append((_dematch_stage(data, _harq_stack(cfg, idxs, pdus, dev), cfg.sch),
                     nvs, snrs, extra))
    return outs


def _harq_stack(cfg: PuschConfig, idxs: list, pdus: list, dev: torch.device):
    """(Ni, C, N) int8 HARQ buffers of a group, zeros for its new-data
    grants; None when every grant of the group is new data."""
    bufs = [pdus[i].harq_buffer for i in idxs]
    known = [b for b in bufs if b is not None]
    if not known:
        return None
    zeros = torch.zeros((cfg.sch.seg.nof_codeblocks, known[0].shape[-1]), dtype=torch.int8,
                        device=dev)
    return torch.stack([zeros if b is None else b.to(dev) for b in bufs])


def _slot_finish(bits_g: list, cfgs: tuple, lead_ns: tuple):
    """Desegment + TB CRC for every group."""
    return [_desegment_stage(bits, cfg.sch, (n,)) for bits, cfg, n in zip(bits_g, cfgs, lead_ns)]


def _decode_group(llr_i8: torch.Tensor, bg: int, z: int, nof_iterations: int,
                  early_stop: bool, n_cb: int | None = None) -> torch.Tensor:
    """(C', N) int8 codeword-buffer LLRs of every grant of a code group ->
    (C', K) bits, in one decode (one K2 launch on the card)."""
    return decode(llr_i8, bg, z, nof_iterations, early_stop=early_stop, bits_only=True,
                  n_cb=n_cb)[0]


def _config_groups(pdus: list) -> dict:
    """PuschConfig (with crb_start 0) -> indices of the PDUs that share it."""
    with l1_tracer.span("ul_slot.group"):
        groups: dict[PuschConfig, list[int]] = {}
        for i, pdu in enumerate(pdus):
            c = pdu.config
            if c.uci is not None and c.uci.csi_report_cfg is not None:
                raise ValueError("two-step CSI PDUs take the per-PDU path (part-2 size follows "
                                 "the decoded RI)")
            # Everything but the absolute CRB (which only seeds the DM-RS,
            # passed per grant) is shared by equal grants at other offsets.
            # PT-RS values also follow the absolute CRB but come from the
            # config, so PT-RS grants keep their crb_start in the key.
            crb = c.alloc.crb_start if c.ptrs_enabled else 0
            key = dataclasses.replace(c, alloc=dataclasses.replace(c.alloc, crb_start=crb))
            groups.setdefault(key, []).append(i)
        return groups


def _code_groups(cfgs: tuple, fronts: list) -> list:
    """Per code group ((base graph, Z, iterations, early stop, n_cb)): its
    key, the config groups in it, their codeblock counts and their
    codeword buffers concatenated to (C', N) int8, the input of its one
    ``_decode_group``."""
    with l1_tracer.span("ul_slot.group"):
        by_code: dict[tuple, list[int]] = {}
        for gi, cfg in enumerate(cfgs):
            seg = cfg.sch.seg
            key = (seg.base_graph, seg.lifting_size, cfg.nof_ldpc_iterations,
                   cfg.ldpc_early_stop, cfg.sch.n_cb)
            by_code.setdefault(key, []).append(gi)
        out = []
        for key, gis in by_code.items():
            flats = [fronts[gi][0].reshape((-1,) + fronts[gi][0].shape[-1:]) for gi in gis]
            out.append((key, gis, [f.shape[0] for f in flats], torch.cat(flats)))
        return out


# The PUCCH formats ``detect_pucch`` detects, in the order it launches them.
PUCCH_FORMATS = (pucch_mod.PucchFormat1Config, pucch_mod.PucchFormat0Config,
                 f2_mod.PucchFormat2Config)


def detect_pucch(grid: torch.Tensor, cfgs) -> list:
    """PUCCH occasions of one (P, nsym, nsc) grid, in any order -> per
    occasion, in input order, F1's (bits, rho), F0's (value, metric) or
    F2's (uci_bits, ok, snr_db): every F1 in one
    ``pucch.format1_detect_all``, each F0 through ``pucch.format0_detect``,
    every F2 in one ``pucch_f2.process_all``.  No occasion, no launch;
    another format raises ValueError."""
    by_format: dict = {kind: [] for kind in PUCCH_FORMATS}
    for j, cfg in enumerate(cfgs):
        if type(cfg) not in by_format:
            raise ValueError(f"no PUCCH detector for {type(cfg).__name__}")
        by_format[type(cfg)].append(j)
    f1, f0, f2 = by_format.values()
    out: dict = {}
    for js, detect in ((f1, pucch_mod.format1_detect_all),
                       (f0, lambda g, cs: [pucch_mod.format0_detect(g, c)[:2] for c in cs]),
                       (f2, f2_mod.process_all)):
        if js:
            out.update(zip(js, detect(grid, [cfgs[j] for j in js])))
    return [out[j] for j in range(len(cfgs))]


def process_slot(grid: torch.Tensor, pdus: list, f1_cfgs=(), f0_cfgs=(), f2_cfgs=()):
    """Decode a heterogeneous multi-UE UL slot.

    grid: (P, nsym, nof_grid_sc) received slot grid; pdus: list[UlSlotPdu]
    with mixed configs; f1_cfgs / f0_cfgs / f2_cfgs: PUCCH F1 / F0 / F2
    occasions on the same grid, through ``detect_pucch``.

    Returns (results, f1_results, f0_results[, f2_results when f2_cfgs])
    as the reference does: results[i] is a dict per input PDU (tb_bits,
    tb_crc_ok, harq_buffer, noise_var, snr_db, with UCI harq_ack_bits,
    csi1_bits, csi2_bits and their _ok flags, with compute_ta ta_s: each
    grant's own); f1_results[j] is (bits, metric); f0_results[k] is
    (value, metric); f2_results[m] is (uci_bits, ok, snr_db)."""
    with l1_tracer.span("ul_slot.process_slot") as span:
        span.count(slots=1)
        groups = _config_groups(pdus)
        cfgs = tuple(groups)
        fronts = _slot_front(grid, groups, pdus)

        bits_g: list = [None] * len(cfgs)
        for (bg, z, iters, es, n_cb), gis, sizes, llrs in _code_groups(cfgs, fronts):
            bits_all = _decode_group(llrs, bg, z, iters, es, n_cb=n_cb)
            for gi, part in zip(gis, bits_all.split(sizes)):
                bits_g[gi] = part

        finished = _slot_finish(bits_g, cfgs, tuple(len(idxs) for idxs in groups.values()))
        results: list = [None] * len(pdus)
        for idxs, (harq, nvs, snrs, extra), (tb, ok) in zip(groups.values(), fronts, finished):
            for k, i in enumerate(idxs):
                results[i] = {
                    "tb_bits": tb[k],
                    "tb_crc_ok": ok[k],
                    "harq_buffer": harq[k],
                    "noise_var": nvs[k],
                    "snr_db": 10.0 * torch.log10(torch.clamp_min(snrs[k], 1e-12)),
                    **{key: v[k] for key, v in extra.items()},
                }
        found = detect_pucch(grid, (*f1_cfgs, *f0_cfgs, *f2_cfgs))
        n1, n0 = len(f1_cfgs), len(f0_cfgs)
        outs = (results, found[:n1], found[n1 : n1 + n0])
        return outs + (found[n1 + n0 :],) if f2_cfgs else outs
