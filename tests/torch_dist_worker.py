"""One rank of the port's multi-rank tests (tests/test_torch_parallel.py).

Run as ``python tests/torch_dist_worker.py <rank> <world> <port> <dir>``,
once per rank, all at the same time: the ranks join a gloo process group
on ``tcp://127.0.0.1:<port>``, read their inputs from ``<dir>/in.npz``,
run the port's parallel layer (``srsran_project_tpu_torch.parallel``) on
the CPU, and each writes what it computed to ``<dir>/out_<rank>.npz``.
The script imports torch and the port, never JAX, so the ranks do not
pull in the JAX test setup; the test compares the outputs with the JAX
package's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# PUSCH configurations of the cases: QAM16, symbols 1-13 with DM-RS on
# symbol 2 (the reference's sharded tests' shape, narrowed): (PRBs, grid
# PRBs, first PRB, TBS, noise method, layers = ports).
CONFIGS = {
    "u24": (24, 24, 0, 2048, "second_difference", 2),  # unpadded on 2 and 4 ranks
    "r24": (24, 24, 0, 2048, "pair_residual", 2),
    "q24": (24, 24, 0, 8192, "second_difference", 4),  # layers 2-3 on CDM group 1
    "p26": (26, 26, 0, 2048, "second_difference", 2),  # 7 PRB a shard on 4: 2 PRB of pad
    "w52": (30, 52, 7, 2048, "second_difference", 2),  # a window at PRB 7 of 52
}
RNTI = 0x4601
CB_BG, CB_Z = 2, 52  # the codeblock-sharded decode's graph

# The cases each world size runs ("fe": front end on each rank's block;
# "dec": decode of each rank's block in both LDPC modes; "enc": sharded
# transmit; "win": windowed decode; "spdp": encode and decode on a 2x2
# sp x dp mesh; "host": the host-aware mesh).
CASES = {
    2: ("halo", "cbdec", "fe:u24", "fe:r24", "fe:q24", "dec:u24", "dec:q24", "enc:u24"),
    4: ("halo", "cbdec", "fe:u24", "fe:p26", "dec:u24", "dec:p26", "win:w52", "enc:p26",
        "spdp:u24", "host"),
}


def pusch_config(pusch, allocation, modulation, name: str):
    """The case's PuschConfig, built from either package's classes."""
    nof_rb, grid_rb, rb_start, tbs, noise, layers = CONFIGS[name]
    return pusch.PuschConfig(
        tbs=tbs, target_code_rate=0.4, modulation=modulation.QAM16,
        alloc=allocation(rb_start=rb_start, rb_count=nof_rb, sym_start=1, sym_count=13,
                         dmrs_symbols=(2,)),
        nof_layers=layers, nof_rx_ports=layers, nof_grid_symbols=14,
        nof_grid_sc=grid_rb * 12, noise_method=noise)


def _decoded(out: dict, prefix: str, res: dict) -> None:
    for key in ("tb_bits", "tb_crc_ok", "noise_var", "snr_db"):
        out[f"{prefix}/{key}"] = res[key].numpy()


def run(rank: int, world: int, port: int, folder: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.parallel import (mesh, multihost, sharded_carrier,
                                                   sharded_decode, sharded_encode,
                                                   sharded_estimator)
    from srsran_project_tpu_torch.phy import pusch
    from srsran_project_tpu_torch.phy.allocation import Allocation

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    inp = np.load(os.path.join(folder, "in.npz"))
    out = {}
    try:
        dp = mesh.make_mesh(tp=1, device_type="cpu")
        sp = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
        for case in CASES[world]:
            kind, _, name = case.partition(":")
            cfg = pusch_config(pusch, Allocation, Modulation, name) if name else None
            grid = torch.from_numpy(inp[f"grid_{name}"]) if name else None
            if kind == "halo":
                h = torch.from_numpy(inp["h"])
                n = h.shape[-1] // world
                out["halo"] = sharded_estimator.smooth_freq_sharded(
                    h[:, rank * n : (rank + 1) * n], dp, "dp").numpy()
            elif kind == "cbdec":
                x, c = sharded_decode.shard_codeblocks(inp["cb_llr"], dp)
                bits, bad = sharded_decode.decode_codeblocks_sharded(x, CB_BG, CB_Z, dp,
                                                                     nof_iterations=4)
                out["cbdec/bits"], out["cbdec/bad"] = bits.numpy(), bad.numpy()
                out["cbdec/c"], out["cbdec/rows"] = np.int64(c), np.int64(x.shape[0])
            elif kind == "fe":
                llr, nv, snr = sharded_carrier.sharded_front_end(
                    sharded_encode.sc_slice(grid, sp, "sp"), cfg, sp)
                try:
                    sharded_carrier.sharded_front_end(grid, cfg, sp)
                    out[f"{case}/whole_refused"] = np.bool_(False)
                except ValueError:
                    out[f"{case}/whole_refused"] = np.bool_(True)
                out[f"{case}/llr"], out[f"{case}/nv"], out[f"{case}/snr"] = (
                    llr.numpy(), nv.numpy(), snr.numpy())
            elif kind == "dec":
                block = sharded_encode.sc_slice(grid, sp, "sp")
                for mode in (False, True):
                    _decoded(out, f"{case}/{int(mode)}", sharded_carrier.sharded_decode(
                        block, RNTI, cfg, sp, sharded_ldpc=mode))
            elif kind == "win":
                _decoded(out, case, sharded_carrier.sharded_decode_windowed(grid, RNTI, cfg, sp))
            elif kind == "enc":
                calls = []
                gather = dist.all_gather

                def counted(*a, **kw):
                    calls.append(1)
                    return gather(*a, **kw)

                dist.all_gather = counted
                try:
                    out[case] = sharded_encode.sharded_transmit(
                        torch.from_numpy(inp[f"tb_{name}"]), RNTI, cfg, sp).numpy()
                finally:
                    dist.all_gather = gather
                out[f"{case}/all_gathers"] = np.int64(len(calls))
            elif kind == "spdp":
                m2 = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("sp", "dp"))
                block = sharded_encode.sharded_transmit(
                    torch.from_numpy(inp[f"tb_{name}"]), RNTI, cfg, m2, cb_axis="dp",
                    sc_axis="sp")
                out[f"{case}/grid"] = block.numpy()
                rx = block + sharded_encode.sc_slice(torch.from_numpy(inp[f"noise_{name}"]),
                                                     m2, "sp")
                _decoded(out, case, sharded_carrier.sharded_decode(
                    rx, RNTI, cfg, m2, axis="sp", sharded_ldpc=True, decode_axis=("sp", "dp")))
            elif kind == "host":
                hm = multihost.host_mesh(nof_hosts=2, tp=1, device_type="cpu")
                cells = torch.arange(8.0).reshape(8, 1)[2 * rank : 2 * rank + 2]
                batch = multihost.global_batch(hm, cells)
                out["host/shape"] = np.array(batch.shape)
                out["host/sum"] = multihost.metrics_allreduce(hm)(batch).numpy()
                out["host/sum_local"] = multihost.metrics_allreduce(hm)(cells).numpy()
                hm2 = multihost.host_mesh(nof_hosts=2, tp=2, device_type="cpu")
                ports = torch.ones((8, 2, 16))
                local = ports[4 * hm2.get_local_rank("host") : 4 * hm2.get_local_rank("host") + 4,
                              hm2.get_local_rank("tp") : hm2.get_local_rank("tp") + 1]
                full = multihost.cell_port_sharding(hm2).from_local(local)
                out["host/port_local"] = np.array(full.to_local().shape)
                out["host/port_global"] = np.array(full.shape)
                out["host/coord"] = np.array(hm2.get_coordinate())
            else:
                raise ValueError(case)
        np.savez(os.path.join(folder, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    print(f"WORKER-OK rank={rank}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    run(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
