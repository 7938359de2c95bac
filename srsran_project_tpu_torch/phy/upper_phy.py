"""Upper PHY slot orchestration: FAPI requests in, grids and indications out.

Port of ``srsran_project_tpu/phy/upper_phy.py``: ``UpperPhy`` turns a
DL_TTI.request + TX_Data.request into the slot's resource grid
(equal-config compact PDSCH grants as one batch through
``pdsch.multi_bit_chain`` and ``pdsch.add_multi_grid``, the halves of
``process_multi``, the others one by one through ``pdsch.process``, then
the PDCCH, SSB and CSI-RS PDUs onto port 0 through ``dl_slot.add_pdcch``,
``add_ssbs`` and ``add_csi_rs``), a UL_DCI.request into PDCCH on a grid
(each call a span, ``upper_phy.process_dl_tti`` with counts ``slots``, the
PDUs of each channel and ``pdsch_batches``, and ``upper_phy.process_ul_dci``
with count ``pdcch``, around the channels' own: ``pdsch.bit_chain``,
``pdsch.grid``, ``pdcch.encode``, ``ssb.assemble``, ``csi_rs.generate``).
A request's structure is planned once (``_DlPlan``: the batches and each
stage's key) and each of those stages runs through
``support/stage_graphs``: on the card a CUDA graph per stage, replayed
inside the stage's span on payloads uploaded in one copy, into a grid the
PHY keeps (each call returns a copy of it).  It turns a UL_TTI.request + received
grid (+ the PRACH occasion's demodulated preamble subcarriers) into CRC
(with the TA where the grant asks for it), RxData, UCI, SRS, RACH and
error indications.  All of the
slot's device work is launched first: two or more compact PUSCH grants
through ``ul_slot.process_slot``, the others through ``pusch.process``,
every PUCCH F0/F1/F2 occasion through ``ul_slot.detect_pucch`` (F3/F4
get an error indication, as in the reference), ``srs.estimate`` and
``prach.detect``.  The call is the span ``upper_phy.process_ul_tti``
(counts ``slots`` and the PDUs of each channel); then its child span
``upper_phy.indications`` launches nothing and reads the results on the
host, its count ``host_syncs`` the number of device values read
(``_host``; each waits for the device).  HARQ soft bits live in a
``HarqBufferPool`` keyed like the reference's trx_buffer_identifier
(rnti, harq id).

Everything runs on ``UpperPhyConfig.device`` (default the card): grids
are made there, request payloads are moved there, and a received grid or
PRACH buffer on another device raises ValueError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fapi import messages as fapi
from ..support.stage_graphs import StageGraphs
from ..support.tracing import l1_tracer
from . import dl_slot as dl_slot_mod
from . import pdsch as pdsch_mod
from . import prach as prach_mod
from . import pucch as pucch_mod
from . import pucch_f2 as pucch_f2_mod
from . import pusch as pusch_mod
from . import srs as srs_mod
from . import ssb as ssb_mod
from . import ul_slot as ul_slot_mod


@dataclasses.dataclass
class UpperPhyConfig:
    """Twin of the reference's ``UpperPhyConfig``, with the device the
    slot's tensors live on."""

    nof_ports: int = 1
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624
    # Debug dump of received UL grids (reference phy_rx_symbols_filename,
    # du_low_config.h): cbf16 binary, one file per call.
    rx_symbols_filename: str | None = None
    validate_requests: bool = False  # run fapi.validators on each request
    device: str = "cuda"


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


# Tensors read on the host, each a wait for the device: the span
# ``upper_phy.indications`` counts its own as ``host_syncs``.
_host_reads = [0]


def _host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    _host_reads[0] += 1
    return x.detach().cpu().numpy()


def rach_indications(res: fapi.SlotResults, detected: dict) -> None:
    """One RACH indication per preamble that ``prach.detect`` found, in
    preamble order, with its metric and TA bin."""
    det, metric, ta = (_host(detected[k]) for k in ("detected", "metric", "ta_samples"))
    for idx in np.nonzero(det)[0]:
        res.rach.append(fapi.RachIndicationPdu(int(idx), float(metric[idx]), float(ta[idx])))


@dataclasses.dataclass(frozen=True)
class _PdschBatch:
    """Equal-config compact PDSCH PDUs (indices into the request) that go
    through one batched bit chain and grid chain, with their stage keys."""

    cfg: object  # the PDUs' PdschConfig with crb_start 0
    pdus: tuple
    first_rbs: tuple
    bit_key: object
    grid_key: object


@dataclasses.dataclass(frozen=True)
class _DlPlan:
    """What a DL_TTI.request's structure decides: the PDSCH batches, the
    PDSCH PDUs that go one by one (in order), and the PDCCH, SSB and
    CSI-RS stages' configs and keys.  ``configs`` holds the request's
    config objects, whose ids key the plan."""

    batches: list
    singles: list
    pdcch: tuple  # (configs, key)
    ssb: tuple  # (configs with sfn_2lsb 0, (first symbol, first subcarrier)s, key)
    csi_rs: tuple | None  # (configs, key)
    configs: tuple


class UpperPhy:
    """One cell's upper PHY."""

    def __init__(self, cfg: UpperPhyConfig):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.harq_pool = HarqBufferPool()
        # PHY taps: observers called at stage boundaries as fn(event, slot,
        # payload) with the grid or the results; they must not mutate it.
        self._taps: list = []
        # The downlink entries' stages (support/stage_graphs), the grid
        # their graphs write, the plans of the requests met (``_dl_plan``)
        # and the stages' key tokens (``_stage_key``).
        self._stages = StageGraphs(self.device)
        self._grid: torch.Tensor | None = None
        self._plans: dict = {}
        self._stage_keys: dict = {}

    def add_tap(self, fn) -> None:
        """Register an observer of 'dl_grid' / 'ul_grid' / 'ul_results'."""
        self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        self._taps.remove(fn)

    def _notify(self, event: str, slot, payload) -> None:
        for fn in self._taps:
            fn(event, slot, payload)

    def _zeros(self) -> torch.Tensor:
        c = self.cfg
        return torch.zeros((c.nof_ports, c.nof_grid_symbols, c.nof_grid_sc),
                           dtype=torch.complex64, device=self.device)

    def _on(self, x, dtype) -> torch.Tensor:
        """A request payload (numpy or tensor) on the PHY's device."""
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _slot_grid(self, src: torch.Tensor | None = None) -> torch.Tensor:
        """The grid a downlink entry's stages add into, zeroed or holding
        ``src``: a new tensor, or the one the stages' graphs write where
        they replay graphs (``_slot_result`` hands out a copy of it)."""
        if not self._stages.enabled:
            return self._zeros() if src is None else src.clone()
        if self._grid is None:
            self._grid = self._zeros()
        return self._grid.zero_() if src is None else self._grid.copy_(src)

    def _slot_result(self, grid: torch.Tensor) -> torch.Tensor:
        return grid.clone() if self._stages.enabled else grid

    # ------------------------------------------------------------------
    # Downlink: DL_TTI.request + TX_Data.request -> resource grid
    # ------------------------------------------------------------------
    def process_dl_tti(self, request: fapi.DlTtiRequest,
                       tx_data: fapi.TxDataRequest) -> torch.Tensor:
        with l1_tracer.span("upper_phy.process_dl_tti") as span:
            span.count(slots=1, pdsch=len(request.pdsch), pdcch=len(request.pdcch),
                       ssb=len(request.ssb), csi_rs=len(request.csi_rs))
            grid, batches = self._process_dl_tti(request, tx_data)
            span.count(pdsch_batches=batches)
            return grid

    def _process_dl_tti(self, request: fapi.DlTtiRequest, tx_data: fapi.TxDataRequest):
        """(the slot's grid, the number of ``process_multi`` batches)."""
        cfg = self.cfg
        if cfg.validate_requests:
            from ..fapi.validators import validate_dl_tti

            validate_dl_tti(request, tx_data, cfg.nof_grid_sc)
        plan = self._dl_plan(request)
        pdsch = request.pdsch
        parts = []
        for b in plan.batches:
            parts += [([tx_data.payloads[pdsch[i].tb_index] for i in b.pdus], np.uint8),
                      ([pdsch[i].rnti for i in b.pdus], np.int64),
                      ([pdsch[i].precoding for i in b.pdus], np.complex64)]
        parts += [([p.rnti for p in request.pdcch], np.int64)] if request.pdcch else []
        parts += [(p.payload, np.uint8) for p in request.pdcch]
        parts += [(p.payload, np.uint8) for p in request.ssb]
        parts += [(ssb_mod._first_scrambling_mask(p.config), np.uint8) for p in request.ssb]
        inputs = iter(self._stages.upload(parts))
        grid = self._slot_grid()
        st = self._stages
        for b in plan.batches:
            tbs, rntis, w = next(inputs), next(inputs), next(inputs)
            cw = st.run("pdsch.bit_chain", {}, b.bit_key,
                        functools.partial(pdsch_mod.multi_bit_chain, cfg=b.cfg), tbs, rntis)
            st.run("pdsch.grid", {"reserved_res": b.cfg.nof_reserved_re * len(b.pdus)},
                   b.grid_key, functools.partial(pdsch_mod.add_multi_grid, grid, b.first_rbs, b.cfg),
                   cw, w)
        for i in plan.singles:
            pdu = pdsch[i]
            sub = pdsch_mod.process(self._on(tx_data.payloads[pdu.tb_index], torch.uint8),
                                    pdu.rnti, self._on(pdu.precoding, torch.complex64),
                                    pdu.config)
            if pdu.first_rb is None:
                grid += sub
            else:
                # A compact-grid PDU goes to its granted PRB offset.
                off = pdu.first_rb * 12
                grid[:, :, off : off + sub.shape[2]] += sub
        if request.pdcch:
            self._run_pdcch(grid, plan.pdcch, [next(inputs) for _ in range(len(request.pdcch) + 1)])
        if request.ssb:
            cfgs, places, key = plan.ssb
            st.run("ssb.assemble", {"ssbs": len(cfgs)}, key,
                   functools.partial(dl_slot_mod.add_ssbs, grid, cfgs, places), *inputs)
        if plan.csi_rs:
            cfgs, key = plan.csi_rs
            st.run("csi_rs.generate",
                   {"resources": len(cfgs), "ports": sum(c.nof_ports for c in cfgs)}, key,
                   functools.partial(dl_slot_mod.add_csi_rs, grid, cfgs))
        grid = self._slot_result(grid)
        self._notify("dl_grid", request.slot, grid)
        return grid, len(plan.batches)

    def _dl_plan(self, request: fapi.DlTtiRequest) -> "_DlPlan":
        """What a DL_TTI.request's structure decides (``_DlPlan``), made once
        per structure: requests whose PDUs hold the same config objects at
        the same places share it."""
        sig = (tuple((id(p.config), p.first_rb) for p in request.pdsch),
               tuple(id(p.config) for p in request.pdcch),
               tuple((id(p.config), p.first_symbol, p.first_subcarrier) for p in request.ssb),
               tuple((p.row, p.rb_start, p.rb_count, p.symbol, p.scrambling_id)
                     for p in request.csi_rs), request.slot.slot_in_frame)
        plan = self._plans.get(sig)
        if plan is not None:
            return plan
        cfg = self.cfg
        csi_cfgs = tuple(dl_slot_mod.csi_rs_config(p, request.slot.slot_in_frame, cfg)
                         for p in request.csi_rs)
        # Equal-config compact PDUs batch into one process_multi pass per
        # config.  The key takes crb_start to 0 (process_multi derives each
        # grant's pilots from its first_rb); only crb_start == first_rb
        # grants batch, since a crb_start = 0 grant at first_rb != 0 would
        # get its DM-RS Gold index from the wrong CRB.
        batched, singles = {}, []
        for i, pdu in enumerate(request.pdsch):
            c = pdu.config
            if (pdu.first_rb is not None and not c.ptrs_enabled
                    and c.alloc.crb_start == pdu.first_rb):
                key = dataclasses.replace(c, alloc=dataclasses.replace(c.alloc, crb_start=0))
                batched.setdefault(key, []).append(i)
            else:
                singles.append(i)
        batches = []
        for cfg_g, idx in batched.items():
            if len(idx) == 1:
                singles.extend(idx)
                continue
            first_rbs = tuple(request.pdsch[i].first_rb for i in idx)
            batches.append(_PdschBatch(cfg_g, tuple(idx), first_rbs,
                                       self._stage_key("pdsch.bit_chain", cfg_g),
                                       self._stage_key("pdsch.grid", cfg_g, first_rbs)))
        pdcch_cfgs = tuple(p.config for p in request.pdcch)
        ssb_cfgs = tuple(dataclasses.replace(p.config, sfn_2lsb=0) for p in request.ssb)
        places = tuple((p.first_symbol, p.first_subcarrier) for p in request.ssb)
        plan = _DlPlan(
            batches=batches, singles=singles,
            pdcch=(pdcch_cfgs, self._stage_key("pdcch", pdcch_cfgs)),
            ssb=(ssb_cfgs, places, self._stage_key("ssb", ssb_cfgs, places)),
            csi_rs=(csi_cfgs, self._stage_key("csi_rs", csi_cfgs)) if csi_cfgs else None,
            configs=tuple(p.config for p in (*request.pdsch, *request.pdcch, *request.ssb)))
        return self._keep_plan(sig, plan)

    def _keep_plan(self, sig: tuple, plan):
        if len(self._plans) >= 1024:
            self._plans.clear()
        self._plans[sig] = plan
        return plan

    def _stage_key(self, *key):
        """A token of a stage's key, one object per distinct key: hashed by
        identity, so a slot's graph lookups do not hash configs."""
        if len(self._stage_keys) >= 4096 and key not in self._stage_keys:
            self._stage_keys.clear()
        return self._stage_keys.setdefault(key, object())

    def _run_pdcch(self, grid: torch.Tensor, pdcch: tuple, inputs: list) -> None:
        cfgs, key = pdcch
        self._stages.run("pdcch.encode", {"pdus": len(cfgs)}, key,
                         functools.partial(dl_slot_mod.add_pdcch, grid, cfgs), *inputs)

    # ------------------------------------------------------------------
    # Uplink: UL_DCI.request, UL_TTI.request + received grid -> indications
    # ------------------------------------------------------------------
    def process_ul_dci(self, request: fapi.UlDciRequest,
                       grid: torch.Tensor | None = None) -> torch.Tensor:
        """Encode the UL_DCI.request PDCCH PDUs onto a new grid, or onto a
        copy of the given one."""
        with l1_tracer.span("upper_phy.process_ul_dci") as span:
            span.count(pdcch=len(request.pdcch))
            grid = self._slot_grid(None if grid is None else self._check_grid(grid))
            if request.pdcch:
                sig = ("ul_dci",) + tuple(id(p.config) for p in request.pdcch)
                plan = self._plans.get(sig)
                if plan is None:
                    cfgs = tuple(p.config for p in request.pdcch)
                    plan = self._keep_plan(sig, (cfgs, self._stage_key("pdcch", cfgs)))
                self._run_pdcch(grid, plan, self._stages.upload(
                    [([p.rnti for p in request.pdcch], np.int64)]
                    + [(p.payload, np.uint8) for p in request.pdcch]))
            return self._slot_result(grid)

    def _check_grid(self, grid) -> torch.Tensor:
        """A received grid (or PRACH buffer) as given: a tensor on the
        PHY's device, else ValueError."""
        if not isinstance(grid, torch.Tensor):
            raise ValueError(f"the grid must be a torch tensor on {self.device}, "
                             f"got {type(grid).__name__}")
        if grid.device.type != self.device.type or (
                self.device.index is not None and grid.device.index != self.device.index):
            raise ValueError(f"the grid lives on {grid.device}, the upper PHY on {self.device}")
        return grid

    def process_ul_tti(self, request: fapi.UlTtiRequest, rx_grid: torch.Tensor,
                       prach_fd: torch.Tensor | None = None) -> fapi.SlotResults:
        """UL_TTI.request + received (P, nsym, nsc) grid -> the slot's
        indications.  prach_fd: the PRACH occasion's (nof_rx_ports, L_RA)
        demodulated preamble subcarriers (``lower_phy.prach_demodulate``)
        for the request's PRACH PDUs; without it each PRACH PDU gets an
        error indication."""
        with l1_tracer.span("upper_phy.process_ul_tti") as span:
            span.count(slots=1, pusch=len(request.pusch), pucch=len(request.pucch),
                       prach=len(request.prach))
            return self._process_ul_tti(request, rx_grid, prach_fd)

    def _process_ul_tti(self, request: fapi.UlTtiRequest, rx_grid: torch.Tensor,
                        prach_fd: torch.Tensor | None) -> fapi.SlotResults:
        rx_grid = self._check_grid(rx_grid)
        if prach_fd is not None:
            prach_fd = self._check_grid(prach_fd)
        res = fapi.SlotResults(slot=request.slot)
        if self.cfg.validate_requests:
            from ..fapi.validators import validate_ul_tti

            validate_ul_tti(request, self.cfg.nof_grid_sc)
        self._notify("ul_grid", request.slot, rx_grid)
        if self.cfg.rx_symbols_filename:
            from ..support import file_vector

            file_vector.write_vector(f"{self.cfg.rx_symbols_filename}.{request.slot.count}",
                                     _host(rx_grid).reshape(-1), "cbf16")
        outs, pucch_outs = self._decode_pusch(request, rx_grid)
        srs = [(e["epre"].mean(), e["noise_var"].mean(), e["phase_slope"].mean(), e["h"])
               for e in (srs_mod.estimate(rx_grid, pdu.config) for pdu in request.srs)]
        rach = [None if prach_fd is None else prach_mod.detect(prach_fd, pdu.config)
                for pdu in request.prach]
        with l1_tracer.span("upper_phy.indications") as span:
            reads = _host_reads[0]
            for pdu, out in zip(request.pusch, outs):
                self._pusch_indications(res, pdu, out)
            for j, pdu in enumerate(request.pucch):
                self._pucch_indication(res, request.slot, pdu, pucch_outs.get(j))
            for pdu, est in zip(request.srs, srs):
                epre, noise_var, slope, h = map(_host, est)
                snr = float(epre) / max(float(noise_var), 1e-12)
                res.srs.append(fapi.SrsIndicationPdu(pdu.rnti, 10.0 * np.log10(max(snr, 1e-12)),
                                                     float(slope), h))
            for found in rach:
                if found is None:
                    res.errors.append(fapi.ErrorIndication(request.slot,
                                                           "PRACH requested, no buffer"))
                else:
                    rach_indications(res, found)
            span.count(host_syncs=_host_reads[0] - reads)
        self._notify("ul_results", request.slot, res)
        return res

    def _decode_pusch(self, request: fapi.UlTtiRequest, rx_grid: torch.Tensor):
        """Every PUSCH PDU's result dict, in PDU order, and every PUCCH
        F0/F1/F2 PDU's result (PDU index -> result).  Two or more compact
        grants without two-step CSI go through ``ul_slot.process_slot``, the
        other grants one by one through ``pusch.process`` on their window;
        then the PUCCH occasions in one ``ul_slot.detect_pucch``."""
        outs: dict[int, dict] = {}
        eligible = [i for i, pdu in enumerate(request.pusch)
                    if (pdu.first_rb is not None
                        and (pdu.config.uci is None or pdu.config.uci.csi_report_cfg is None)
                        and pdu.config.alloc.crb_start == pdu.first_rb)]
        if len(eligible) >= 2:
            slot_pdus = []
            for i in eligible:
                p = request.pusch[i]
                hb = None if p.new_data else self.harq_pool.get(p.rnti, p.harq_id)
                slot_pdus.append(ul_slot_mod.UlSlotPdu(rnti=p.rnti, first_rb=p.first_rb,
                                                       config=p.config, harq_buffer=hb))
            outs.update(zip(eligible, ul_slot_mod.process_slot(rx_grid, slot_pdus)[0]))
        for i, pdu in enumerate(request.pusch):
            if i in outs:
                continue
            harq = None if pdu.new_data else self.harq_pool.get(pdu.rnti, pdu.harq_id)
            pdu_grid = rx_grid
            if pdu.first_rb is not None:
                off = pdu.first_rb * 12
                pdu_grid = rx_grid[:, :, off : off + pdu.config.nof_grid_sc]
            out = pusch_mod.process(pdu_grid[None],
                                    torch.tensor([pdu.rnti], dtype=torch.int64,
                                                 device=self.device),
                                    pdu.config, harq_buffer=None if harq is None else harq[None])
            outs[i] = {k: v[0] for k, v in out.items()}
        js = [j for j, p in enumerate(request.pucch)
              if isinstance(p.config, ul_slot_mod.PUCCH_FORMATS)]
        found = ul_slot_mod.detect_pucch(rx_grid, [request.pucch[j].config for j in js])
        return [outs[i] for i in range(len(request.pusch))], dict(zip(js, found))

    def _pusch_indications(self, res: fapi.SlotResults, pdu, out: dict) -> None:
        """CRC, UCI and RxData indications of one PUSCH PDU, and its HARQ
        buffer kept (CRC failed) or released (CRC passed)."""
        ok = bool(_host(out["tb_crc_ok"]))
        for bits_key, ok_key in ("harq_ack_bits", "harq_ack_ok"), ("csi1_bits", "csi1_ok"), \
                                ("csi2_bits", "csi2_ok"):
            if bits_key in out:
                res.uci.append(fapi.UciIndicationPdu(pdu.rnti, _host(out[bits_key]),
                                                     bool(_host(out[ok_key])), 0.0))
        res.crc.append(fapi.CrcIndicationPdu(
            pdu.rnti, pdu.harq_id, ok, snr_db=float(_host(out["snr_db"])),
            ta_s=float(_host(out["ta_s"])) if "ta_s" in out else None))
        if ok:
            res.rx_data.append(fapi.RxDataIndicationPdu(pdu.rnti, pdu.harq_id,
                                                        _host(out["tb_bits"])))
            self.harq_pool.release(pdu.rnti, pdu.harq_id)
        else:
            self.harq_pool.put(pdu.rnti, pdu.harq_id, out["harq_buffer"])

    def _pucch_indication(self, res: fapi.SlotResults, slot, pdu, found) -> None:
        """The UCI indication of one PUCCH PDU from its ``detect_pucch``
        result; F3 and F4, with none, get an error indication, as in the reference."""
        c = pdu.config
        if isinstance(c, pucch_mod.PucchFormat0Config):
            val, metric = found
            # The candidate index carries the HARQ bits; with an SR
            # opportunity the upper half of the candidates means a positive
            # SR, sent as a trailing bit.
            n_base = max(1, 1 << c.nof_harq_bits)
            val, metric = int(_host(val)), float(_host(metric))
            harq_val = val % n_base
            bits = [(harq_val >> i) & 1 for i in range(c.nof_harq_bits)]
            if c.sr_opportunity:
                bits.append(1 if val >= n_base else 0)
            res.uci.append(fapi.UciIndicationPdu(
                pdu.rnti, np.asarray(bits, np.uint8), metric > pucch_mod.F0_DTX_THRESHOLD, metric))
        elif isinstance(c, pucch_mod.PucchFormat1Config):
            bits, metric = found
            metric = float(_host(metric))
            res.uci.append(fapi.UciIndicationPdu(
                pdu.rnti, _host(bits), metric > pucch_mod.F1_DTX_THRESHOLD, metric))
        elif isinstance(c, pucch_f2_mod.PucchFormat2Config):
            bits, ok, snr = found
            res.uci.append(fapi.UciIndicationPdu(pdu.rnti, _host(bits), bool(_host(ok)),
                                                 float(_host(snr))))
        else:
            res.errors.append(fapi.ErrorIndication(slot, f"unsupported PUCCH {type(c)}"))
