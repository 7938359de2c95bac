"""Polar coding chain for UCI: construction, encode, rate match, SC decode
(port of ``srsran_project_tpu/ops/polar``)."""

from .code import PolarCode, construct  # noqa: F401
from .decoder import decode  # noqa: F401
from .encoder import encode, polar_transform, rate_dematch_llrs  # noqa: F401
