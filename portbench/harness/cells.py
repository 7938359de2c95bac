"""What every generator shares: the configuration and traffic files read
and checked key by key, the UEs of a configuration, the reference's grant
and the program's ``CellConfig`` of each, the inputs that every entry
draws, and the numbers that hold decoded slots to the reference's.

A traffic file's ``generator`` names the module
``portbench/generators/<generator>.py`` that makes the pool from the seed
and drives the program's entry; a configuration's ``channel.kind`` names
``portbench/channels/<kind>.py``.  Each file states only keys that some
code reads: a key that no code reads, or a value that the code does not
cover, is refused before any run.

The inputs are the reference transmitter's (``portbench/reference``), made
on the device from ``torch.Generator(device).manual_seed(seed)``:
payloads, RNTIs, the channel of each slot and UE and complex AWGN at the
configuration's SNR per resource element.  The program gets only these
inputs; the reference recomputes everything else itself.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import spec as spec_mod
from portbench.reference import link, nr

CONFIG_KEYS = {"name", "source", "deployment", "carrier", "nof_rx_ports", "symbols", "ues",
               "tbs_lbrm_bytes", "receiver", "channel", "expected", "assumed", "reduced"}
CARRIER_KEYS = {"nof_rb", "scs_khz", "f_center_hz"}
SYMBOL_KEYS = {"start", "count", "dmrs"}
UE_KEYS = {"count", "layers", "modulation_order", "target_code_rate_x1024", "nof_rb"}
RECEIVER_KEYS = {"equalizer", "demapper", "noise_method", "sinr_method", "nof_ldpc_iterations",
                 "ldpc_early_stop", "llr_range_limit"}
EXPECTED_KEYS = {"tbs", "codeblocks", "base_graph", "lifting_size"}
TRAFFIC_KEYS = {"generator", "pool_units", "warmup_calls", "check_units", "trace_rounds", "why",
                "source"}
# What the reference receiver covers, key by key.
RECEIVER_COVERS = {"equalizer": "mmse", "demapper": "float", "noise_method": "second_difference",
                   "sinr_method": "post_equalization"}
SCS_INDEX = {15: 0, 30: 1, 60: 2}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generator(name: str):
    """The module ``portbench/generators/<name>.py``."""
    return spec_mod.module("generators", name)


def channel(kind: str):
    """The module ``portbench/channels/<kind>.py``."""
    return spec_mod.module("channels", kind)


def _keys(d: dict, allowed: set, where: str) -> None:
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"{where}: keys that no code reads: {sorted(unknown)}")


def check_files(config: dict, traffic: dict, gen_module) -> None:
    """Refuses a key that no code reads in the configuration or the
    traffic file, and a receiver that the reference does not cover."""
    _keys(config, CONFIG_KEYS | set(gen_module.CONFIG_KEYS), "configuration")
    _keys(config["carrier"], CARRIER_KEYS, "configuration carrier")
    _keys(config["symbols"], SYMBOL_KEYS, "configuration symbols")
    _keys(config["expected"], EXPECTED_KEYS, "configuration expected")
    _keys(config["receiver"], RECEIVER_KEYS, "configuration receiver")
    for group in config["ues"]:
        _keys(group, UE_KEYS, "configuration ues")
    _keys(config["channel"], {"kind", "snr_db"} | set(channel(config["channel"]["kind"]).PARAMS),
          "configuration channel")
    _keys(traffic, TRAFFIC_KEYS | set(gen_module.TRAFFIC_KEYS), "traffic")
    for key, want in RECEIVER_COVERS.items():
        if config["receiver"][key] != want:
            raise ValueError(f"the reference receiver covers {key}={want!r}, "
                             f"not {config['receiver'][key]!r}")
    if config["carrier"]["scs_khz"] not in SCS_INDEX:
        raise ValueError(f"subcarrier spacing {config['carrier']['scs_khz']} kHz")


def entry(config: dict, traffic: dict, seed: int, dev: torch.device):
    """The ``Entry`` of the traffic's generator, its pool made from the seed."""
    gen_module = generator(traffic["generator"])
    check_files(config, traffic, gen_module)
    return gen_module.Entry(config, traffic, seed, dev)


def ue_layout(config: dict) -> list:
    """Per UE: dict(first_rb, nof_rb, layers, qm, rate), in PRB order."""
    out, rb = [], 0
    for group in config["ues"]:
        for _ in range(group["count"]):
            out.append(dict(first_rb=rb, nof_rb=group["nof_rb"], layers=group["layers"],
                            qm=group["modulation_order"],
                            rate=group["target_code_rate_x1024"] / 1024.0))
            rb += group["nof_rb"]
    if rb > config["carrier"]["nof_rb"]:
        raise ValueError(f"the UEs take {rb} PRBs of a {config['carrier']['nof_rb']}-PRB carrier")
    return out


def grant(config: dict, ue: dict, rv: int = 0) -> link.Grant:
    sym, rx = config["symbols"], config["receiver"]
    return link.Grant(nof_rb=ue["nof_rb"], first_rb=ue["first_rb"], layers=ue["layers"],
                      qm=ue["qm"], rate=ue["rate"], nof_ports=config["nof_rx_ports"], rv=rv,
                      sym_start=sym["start"], sym_count=sym["count"],
                      dmrs_symbols=tuple(sym["dmrs"]), nof_iterations=rx["nof_ldpc_iterations"],
                      early_stop=rx["ldpc_early_stop"], llr_range_limit=rx["llr_range_limit"],
                      tbs_lbrm_bytes=config["tbs_lbrm_bytes"])


def program_cell(config: dict, ue: dict):
    """The program's ``CellConfig`` of one UE's window."""
    from srsran_project_tpu_torch.models.cell import CellConfig
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing

    sym, rx, car = config["symbols"], config["receiver"], config["carrier"]
    return CellConfig(
        nof_rb=ue["nof_rb"], scs=SubcarrierSpacing(SCS_INDEX[car["scs_khz"]]),
        nof_ports=config["nof_rx_ports"], nof_layers=ue["layers"],
        modulation=Modulation(ue["qm"]), target_code_rate=ue["rate"],
        f_center_hz=float(car["f_center_hz"]), sym_start=sym["start"], sym_count=sym["count"],
        dmrs_symbols=tuple(sym["dmrs"]), nof_ldpc_iterations=rx["nof_ldpc_iterations"],
        ldpc_early_stop=rx["ldpc_early_stop"], equalizer=rx["equalizer"],
        sinr_method=rx["sinr_method"], llr_range_limit=float(rx["llr_range_limit"]),
        demapper=rx["demapper"], noise_method=rx["noise_method"])


def check_geometry(config: dict, grants: list, program_tbs: list) -> None:
    """The reference's TBS equal to the program's, and the TBS, codeblocks,
    base graphs and lifting sizes of the grants those the configuration
    states, in the order of its UE groups."""
    got = [g.tbs for g in grants]
    if got != list(program_tbs):
        raise ValueError(f"TBS: reference {got}, program {list(program_tbs)}")
    seen: dict = {}
    for g in grants:
        seen.setdefault(g.tbs, (g.tbs, g.seg.c, g.seg.bg, g.seg.z))
    want = config["expected"]
    states = list(zip(want["tbs"], want["codeblocks"], want["base_graph"], want["lifting_size"]))
    if sorted(seen.values()) != sorted(states):
        raise ValueError(f"grants (TBS, codeblocks, base graph, lifting size): "
                         f"{sorted(seen.values())}, the configuration states {sorted(states)}")


def sigma(config: dict) -> float:
    return float(np.sqrt(10.0 ** (-config["channel"]["snr_db"] / 10.0)))


def rntis(gen: torch.Generator, shape, dev: torch.device) -> torch.Tensor:
    """C-RNTIs in 0x0001-0xFFEF."""
    return torch.randint(1, 0xFFF0, shape, generator=gen, device=dev, dtype=torch.int64)


class Entry:
    """What every entry has: the pool's units, the calls a unit takes, the
    slots a call carries, the seeded generator and the channel module.

    A generator's ``Entry`` adds ``generate(unit, step, prev)`` (the call's
    arguments; ``prev`` the previous call's answer), ``dispatch(args)`` (the
    program's call), ``readback(out)`` (the answer on the host),
    ``expected(units, precision)`` (the reference's results per unit and
    step), ``compare(got, want)`` (the numbers compared, by name) and
    ``decoded_tbs(unit, step, reference)`` (the TBs a call decodes, as
    (grant, iterations the reference needed per codeblock)); and
    ``ldpc_kernel``, the program's LDPC decoder kernel that a call
    launches (``"K1"``, ``"K2"`` or None)."""

    slots_per_call = 1
    calls_per_unit = 1
    ldpc_kernel = None

    def __init__(self, config: dict, traffic: dict, seed: int, dev: torch.device):
        self.dev = dev
        self.units = int(traffic["pool_units"])
        self.gen = torch.Generator(device=dev).manual_seed(int(seed))
        car = config["carrier"]
        self.scs, self.fc = car["scs_khz"], float(car["f_center_hz"])
        self.dft = nr.min_dft_size(car["nof_rb"])
        self.channel = channel(config["channel"]["kind"])
        self.channel_params = {k: v for k, v in config["channel"].items()
                               if k not in ("kind", "snr_db")}

    def draw_channel(self, n: int, layers: int, ports: int) -> torch.Tensor:
        return self.channel.draw(self.gen, n, layers, ports, self.dev, self.channel_params)


class SingleUe(Entry):
    """One UE on the whole carrier: ``slots_per_call`` slots a call, a pool
    of ``pool_units`` calls' distinct payloads and RNTIs."""

    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        ues = ue_layout(config)
        if len(ues) != 1 or ues[0]["nof_rb"] != config["carrier"]["nof_rb"]:
            raise ValueError(f"{traffic['generator']} takes one UE on the whole carrier")
        self.ue = ues[0]
        self.grant = grant(config, self.ue)
        self.cfg = program_cell(config, self.ue)
        check_geometry(config, [self.grant], [self.cfg.tbs])
        self.slots_per_call = int(traffic["slots_per_call"])
        n = self.units * self.slots_per_call
        self.tb = torch.randint(0, 2, (n, self.grant.tbs), generator=self.gen, device=dev,
                                dtype=torch.uint8)
        self.rnti = rntis(self.gen, (n,), dev)

    def unit_slice(self, t: torch.Tensor, unit: int) -> torch.Tensor:
        b = self.slots_per_call
        return t[unit * b:(unit + 1) * b]


def batched(out: dict) -> dict:
    """A result of one unbatched slot with the slot batch added."""
    if out["tb_bits"].dim() == 1:
        return {k: v[None] for k, v in out.items()}
    return out


def compare_ul(pairs: list) -> dict:
    """The numbers that hold decoded slots to the reference's: CRC verdicts
    that differ, TB bits that differ where the reference's CRC passes, the
    largest relative gap of the noise variance and the largest gap of the
    SINR in dB.  pairs: [(program result, reference result)], batched."""
    crc = bits = 0
    nv_gap = snr_gap = 0.0
    for got, ref in pairs:
        ok_p, ok_r = got["tb_crc_ok"].cpu(), ref["tb_crc_ok"].cpu()
        crc += int((ok_p != ok_r).sum())
        diff = (got["tb_bits"].to(ref["tb_bits"].device) != ref["tb_bits"]).sum(dim=-1).cpu()
        bits += int(diff[ok_r].sum())
        nv_p = got["noise_var"].to(ref["noise_var"].device)
        nv_gap = max(nv_gap, float(((nv_p - ref["noise_var"]).abs() / ref["noise_var"]).max()))
        snr_p = got["snr_db"].to(ref["snr_db"].device)
        snr_gap = max(snr_gap, float((snr_p - ref["snr_db"]).abs().max()))
    return {"crc_mismatch": crc, "tb_bit_mismatch": bits, "noise_var_gap": nv_gap,
            "snr_db_gap": snr_gap}
