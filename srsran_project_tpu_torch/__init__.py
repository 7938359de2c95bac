"""srsran_project_tpu_torch — the PyTorch/CUDA port of srsran_project_tpu.

The flagship 100 MHz 4x4 slot (PDSCH encode -> IQ -> PUSCH decode) on an
NVIDIA Hopper card.  The layout mirrors the JAX package module for module
so each counterpart is easy to find; the JAX package stays the reference
every port function is tested against.

Rules of the package:

* it imports ``torch`` and numpy, and never ``jax`` (the machine with the
  card has no JAX); from ``srsran_project_tpu`` it reuses only the
  JAX-free host modules ``ran.constants``, ``ran.dmrs``, ``ran.tbs``,
  ``phy.allocation`` and ``ops.ldpc.graphs``;
* the device follows the input tensor: a CUDA tensor goes to the
  hand-written kernel (``csrc/``), a CPU tensor to the kernel's plain
  torch version beside it, with no fallback between the two;
* public functions keep the reference's shapes and layouts, with a
  leading slot-batch dimension in place of ``vmap``/``lax.scan``.

Subpackages
-----------
ops      crc, scrambling, ldpc (segment/encode/rate match, K1 decode),
         modulation (map/demap/evm), ofdm, estimator, equalizer (K3)
phy      shared-channel coding (sch), PDSCH bit/grid chains, PUSCH front end
models   the flagship cell: encode_slot / decode_slot
csrc     CUDA C++ sources of the Hopper kernels (built at first use)
"""
