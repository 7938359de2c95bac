"""RU factory: one entry point selecting the RU implementation.

A copy of ``srsran_project_tpu/ru/factory.py``.

Counterpart of the reference's per-flavor factories
(lib/ru/dummy/ru_dummy_factory.cpp, lib/ru/generic/ru_factory_generic_impl.cpp,
lib/ru/ofh) behind apps' ``ru_cfg.type`` switch.
"""

from __future__ import annotations

from .dummy import RuDummy, RuDummyConfig
from .generic import RuGeneric, RuGenericConfig
from .ofh_ru import RuOfh, RuOfhConfig, RuOfhMultiSector


def create_ru(kind: str, config, symbol_notifier, **kwargs):
    """kind in {"dummy", "generic", "ofh"}; config must match the kind."""
    want = {"dummy": RuDummyConfig, "generic": RuGenericConfig, "ofh": RuOfhConfig}.get(kind)
    if want is None:
        raise ValueError(f"unknown RU kind: {kind!r}")
    # A list/tuple of sector configs selects the multi-sector OFH RU
    # (reference ru_ofh_impl's sector vector).
    multi = kind == "ofh" and isinstance(config, (list, tuple))
    if not all(isinstance(c, want) for c in (config if multi else [config])):
        raise TypeError(f"create_ru({kind!r}) takes a {want.__name__}")
    if kind == "dummy":
        return RuDummy(config, symbol_notifier, **kwargs)
    if kind == "generic":
        return RuGeneric(config, symbol_notifier, **kwargs)
    if multi:
        return RuOfhMultiSector(list(config), symbol_notifier, **kwargs)
    return RuOfh(config, symbol_notifier, **kwargs)
