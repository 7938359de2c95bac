"""Radio Unit abstraction layer (port of ``srsran_project_tpu/ru``).

Counterpart of the reference's RU interface family
(include/srsran/ru/ru.h, ru_controller.h, ru_downlink_plane.h,
ru_uplink_plane.h, ru_timing_notifier.h) and its three implementations
(lib/ru/dummy, lib/ru/generic, lib/ru/ofh).  The upper layers (du_low /
upper PHY) talk only to :class:`RadioUnit`; which transport sits behind it
(nothing, the UDP-IQ baseband loop, or the OFH framer) is a factory choice.
"""

from .interface import (
    PrachBufferContext,
    ResourceGridContext,
    RadioUnit,
    RuController,
    RuDownlinkPlaneHandler,
    RuErrorNotifier,
    RuMetrics,
    RuTimingNotifier,
    RuUplinkPlaneHandler,
    RxSymbolContext,
    RxSymbolNotifier,
)
from .dummy import RuDummy, RuDummyConfig
from .generic import RuGeneric, RuGenericConfig
from .ofh_ru import RuOfh, RuOfhConfig, RuOfhMultiSector
from .factory import create_ru

__all__ = [
    "PrachBufferContext",
    "ResourceGridContext",
    "RadioUnit",
    "RuController",
    "RuDownlinkPlaneHandler",
    "RuErrorNotifier",
    "RuMetrics",
    "RuTimingNotifier",
    "RuUplinkPlaneHandler",
    "RxSymbolContext",
    "RxSymbolNotifier",
    "RuDummy",
    "RuDummyConfig",
    "RuGeneric",
    "RuGenericConfig",
    "RuOfh",
    "RuOfhConfig",
    "RuOfhMultiSector",
    "create_ru",
]
