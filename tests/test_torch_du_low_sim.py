"""The port's ``du_low_sim`` (single-UE mode) and its configuration
against the JAX package's.

The app runs on the CPU here (``--cpu``) at a small ``--set`` config; one
of its slots, the same TB and the same received grid through the JAX
package's ``UpperPhy`` give the same DL grid (within 1e-6 x RMS) and the
same indications (CRC and TB bits exact, snr_db atol 1e-3)."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_dl_slot import assert_grid_close
from torch_parity import to_np

from srsran_project_tpu.fapi import messages as jfapi
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu.support import config as jconfig
from srsran_project_tpu_torch.apps import du_low_sim
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.phy import channel_emulator as tchem
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.support import config as tconfig

SMALL = ["--cpu", "--set", "cell.nof_rb=24", "--set", "cell.nof_ports=2",
         "--set", "cell.nof_layers=1", "--set", "cell.modulation=qam16",
         "--channel", "single", "--snr-db", "30", "--slots", "3"]
OVERRIDES = {"cell.nof_rb": 24, "cell.nof_ports": 2, "cell.nof_layers": 1,
             "cell.modulation": "qam16"}


def test_app_runs_clean(capsys):
    assert du_low_sim.main(SMALL) == 0
    err = capsys.readouterr().err
    assert "# cell: 24 PRB, 2x1" in err and "device=cpu" in err
    assert "# 3 slots in " in err and "BLER=0.000" in err


def test_app_needs_a_card_without_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert du_low_sim.main([a for a in SMALL if a != "--cpu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flag", sorted(du_low_sim.DEFERRED))
def test_deferred_flags_name_their_item(flag):
    value = {"ues": "2", "policy": "qos", "cells": "2", "ru": "generic", "pcap": "x.pcap",
             "remote_port": "0", "trace": "t.json", "metrics_interval_slots": "5"}.get(flag)
    arg = ["--" + flag.replace("_", "-")] + ([value] if value is not None else [])
    item = du_low_sim.DEFERRED[flag][1]
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}\b"):
        du_low_sim.main(SMALL + arg)


def test_config_twin(capsys):
    """load_config / validate / to_cell_config / dump_config give the JAX
    package's values, and the port's defaults need no YAML file."""
    jd = jconfig.load_config(None, OVERRIDES)
    td = tconfig.load_config(None, OVERRIDES)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tconfig.to_cell_config(td) == tcell.CellConfig.from_reference(jconfig.to_cell_config(jd))
    assert tconfig.to_cell_config(tconfig.load_config()) == tcell.CellConfig()
    assert tconfig.dump_config(td) == jconfig.dump_config(jd)
    for bad in ({"cell.nof_rb": 300}, {"cell.modulation": "qam1024"},
                {"cell.nof_layers": 4, "cell.nof_ports": 2}):
        with pytest.raises(ValueError):
            jconfig.load_config(None, bad)
        with pytest.raises(ValueError):
            tconfig.load_config(None, bad)
    with pytest.raises(KeyError):
        tconfig.load_config(None, {"cell.no_such_field": 1})
    assert du_low_sim.main(SMALL + ["--dump-config"]) == 0
    assert "nof_rb: 24" in capsys.readouterr().out


def test_one_slot_against_the_reference():
    """The app's slot 0 (its requests, its TB and its channel draw) through
    the port's UpperPhy, and the same TB and received grid through the JAX
    package's."""
    cell = tconfig.to_cell_config(tconfig.load_config(None, OVERRIDES))
    jcell = jconfig.to_cell_config(jconfig.load_config(None, OVERRIDES))
    tb = np.random.default_rng(0).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    dl, tx_data, ul = du_low_sim.slot_requests(cell, 0, tb)
    tphy = TUpperPhy(TUpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                     device="cpu"))
    jphy = JUpperPhy(JUpperPhyConfig(nof_ports=jcell.nof_ports, nof_grid_sc=jcell.nof_sc))
    slot = JSlot.from_sfn_slot(JScs(int(jcell.scs)), 0, 0)
    w = np.eye(jcell.nof_layers, jcell.nof_ports, dtype=np.complex64)
    grid_j = np.asarray(jphy.process_dl_tti(
        jfapi.DlTtiRequest(slot=slot, pdsch=[jfapi.DlPdschPdu(jcell.pdsch_cfg, 0x4601, w, 0)]),
        jfapi.TxDataRequest(slot=slot, payloads=[tb])))
    grid_t = tphy.process_dl_tti(dl, tx_data)
    assert_grid_close(to_np(grid_t), grid_j)
    ch = tchem.ChannelConfig(profile="tdla", sinr_db=22.0, nof_tx_ports=cell.nof_ports,
                             nof_rx_ports=cell.nof_ports, nof_sc=cell.nof_sc, scs=cell.scs)
    rx, _, _ = tchem.apply_channel(grid_t, torch.Generator().manual_seed(1), ch)
    res_t = tphy.process_ul_tti(ul, rx)
    res_j = jphy.process_ul_tti(
        jfapi.UlTtiRequest(slot=slot, pusch=[jfapi.UlPuschPdu(jcell.pusch_cfg, 0x4601)]),
        to_np(rx))
    assert res_t.crc[0].tb_crc_ok and res_j.crc[0].tb_crc_ok
    assert abs(res_t.crc[0].snr_db - res_j.crc[0].snr_db) <= 1e-3
    np.testing.assert_array_equal(res_t.rx_data[0].payload, np.asarray(res_j.rx_data[0].payload))
    np.testing.assert_array_equal(res_t.rx_data[0].payload, tb)
