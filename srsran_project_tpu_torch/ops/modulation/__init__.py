"""QAM modulation mapping, soft demapping and EVM."""

from .mapper import Modulation, bits_per_symbol, map_bits  # noqa: F401
from .demapper import demap_soft, quantize_llr  # noqa: F401
