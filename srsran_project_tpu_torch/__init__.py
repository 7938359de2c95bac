"""srsran_project_tpu_torch — the PyTorch/CUDA port of srsran_project_tpu.

The flagship 100 MHz 4x4 slot (PDSCH encode -> IQ -> PUSCH decode), the
multi-UE uplink slot, every PUSCH/PDSCH allocation shape and waveform,
and the DU-low's FAPI entry point (the upper PHY with the whole downlink
slot, SRS and the TDL channel emulator) on an NVIDIA Hopper card.  The layout mirrors the JAX package module for module
so each counterpart is easy to find; the JAX package stays the reference
every port function is tested against.

Rules of the package:

* it imports ``torch`` and numpy, never ``jax`` (the machine with the
  card has no JAX), and nothing of ``srsran_project_tpu``, not even a
  module there that imports no JAX: it keeps its own copies of the host
  modules it needs (``ran.constants``, ``ran.dmrs``, ``ran.tbs``,
  ``ran.slot_point``, ``phy.allocation``, ``ops.ldpc.graphs`` with its
  ``_bg_tables.npz``, ``support.file_vector``),
  which the tests hold equal to the reference's value for value;
* the device follows the input tensor: a CUDA tensor goes to the
  hand-written kernel (``csrc/``), a CPU tensor to the kernel's plain
  torch version beside it, with no fallback between the two;
* public functions keep the reference's shapes and layouts, with a
  leading slot-batch dimension in place of ``vmap``/``lax.scan``.

Subpackages
-----------
ran      constants, TBS, DM-RS geometry, UL-SCH sizes, CSI reports, slot points
         (copies of the reference's)
ops      crc, scrambling, ldpc (graphs, segment/encode/rate match, K1 and
         K2 decode), modulation (map/demap/evm, BPSK to 256QAM), ofdm,
         transform precoding, estimator, equalizer (per subcarrier with
         K3, per RE), demap_planes (K4), polar, short block, UCI codecs
phy      allocation, shared-channel coding (sch), PDSCH (process: every
         allocation shape, PT-RS, DFT-s; process_multi), PUSCH front ends
         and back end (UCI on PUSCH, two-step CSI), PUCCH, the multi-UE
         uplink slot (ul_slot), PDCCH, SSB, CSI-RS, the DL broadcast
         (dl_slot), SRS, the upper PHY (UpperPhy), validators, the
         channel emulator
fapi     the FAPI messages and their validators
support  the DU-low config (YAML optional), file vectors
apps     du_low_sim (single-UE mode)
models   the flagship cell: encode_slot / decode_slot
csrc     CUDA C++ sources of the Hopper kernels (built at first use)
"""
