"""Composable application units.

Counterpart of the reference's apps/units layer (application_unit.h,
flexible_o_du/o_du_unit.h): each subsystem ships as a unit that
contributes its config schema, constructs its component against named
dependencies, and exposes runtime commands + metrics.  An app is a
composition of units rather than a hand-wired script; `compose_gnb()`
builds the standard monolithic topology (AMF + CU-CP + CU-UP-E1 + DU-F1
+ DU-high + upper PHY) the way apps/gnb assembles o_cu_cp + o_cu_up +
flexible_o_du units.

Late binding: control-plane links are name-resolved through the
composition's link table, so units can be declared in any order (the
reference achieves the same with its gateway/connector interfaces).

A copy of ``srsran_project_tpu/units.py`` with two differences: ``build``
is an abstract method, so a unit class without it fails when it is
constructed (the reference's base ``build`` raises only when it is
called), and the CU-CP unit's ``start_handover`` command is the
CU-CP's own method (mobility is a base of ``CuCpSim`` in the port).
``UpperPhyUnit`` builds the port's ``UpperPhy`` on its config's device
(``UpperPhyConfig.device``, the card unless the config says otherwise).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable


class ApplicationUnit(abc.ABC):
    """Base unit: override `name`, `build`, and optionally the hooks."""

    name: str = "unit"
    requires: tuple[str, ...] = ()

    def register_config(self, schema: dict) -> None:
        """Contribute config defaults (reference
        on_parsing_configuration_registration)."""

    @abc.abstractmethod
    def build(self, ctx: "Composition") -> Any:
        """Construct the unit's component against the composition."""

    def commands(self, instance: Any) -> dict[str, Callable]:
        """Runtime commands (reference application_unit_commands.h)."""
        return {}

    def metrics(self, instance: Any) -> dict:
        return {}


@dataclasses.dataclass
class Composition:
    """Resolved units + late-bound link table."""

    config: dict
    units: dict[str, ApplicationUnit] = dataclasses.field(default_factory=dict)
    instances: dict[str, Any] = dataclasses.field(default_factory=dict)
    links: dict[str, Any] = dataclasses.field(default_factory=dict)

    def link(self, name: str) -> Callable[[bytes], None]:
        """A callable that forwards to links[name].rx at call time (late
        binding: the target may not be built yet)."""
        return lambda b: self.links[name].rx(b)

    def commands(self) -> dict[str, Callable]:
        out: dict[str, Callable] = {}
        for name, unit in self.units.items():
            for cmd, fn in unit.commands(self.instances[name]).items():
                out[f"{name}.{cmd}"] = fn
        return out

    def metrics(self) -> dict:
        return {name: unit.metrics(self.instances[name])
                for name, unit in self.units.items()}


class Composer:
    def __init__(self, config: dict | None = None):
        self._units: list[ApplicationUnit] = []
        self._config = dict(config or {})

    def add(self, unit: ApplicationUnit) -> "Composer":
        self._units.append(unit)
        return self

    def compose(self) -> Composition:
        schema: dict = {}
        for u in self._units:
            u.register_config(schema)
        schema.update(self._config)
        ctx = Composition(config=schema)
        for u in self._units:
            ctx.units[u.name] = u
        # Build in declaration order; links resolve lazily via ctx.link().
        for u in self._units:
            missing = [r for r in u.requires if r not in ctx.units]
            if missing:
                raise ValueError(f"unit {u.name} requires {missing}")
            ctx.instances[u.name] = u.build(ctx)
        return ctx


# ---------------------------------------------------------------------------
# Concrete units (reference o_cu_cp / o_cu_up / flexible_o_du roles)
# ---------------------------------------------------------------------------


class AmfUnit(ApplicationUnit):
    name = "amf"

    def build(self, ctx: Composition):
        from .l3.amf_sim import AmfSim

        amf = AmfSim()
        ctx.links["amf"] = amf
        return amf


class CuCpUnit(ApplicationUnit):
    name = "cu_cp"
    requires = ("amf",)

    def register_config(self, schema: dict) -> None:
        schema.setdefault("gnb_id", 411)
        schema.setdefault("plmn", "00101")
        schema.setdefault("tac", 7)

    def build(self, ctx: Composition):
        from .l3.cu_cp_sim import CuCpSim

        cucp = CuCpSim(send_to_amf=ctx.link("amf"),
                       send_to_du=ctx.link("du_f1"),
                       send_to_cuup=ctx.link("cu_up_e1"))
        ctx.instances["amf"].send = cucp.rx_from_amf
        ctx.links["cu_cp"] = _Rx(cucp.rx_from_du)
        return cucp

    def commands(self, cucp) -> dict[str, Callable]:
        return {"release_ue": cucp.release_ue,
                "start_handover": cucp.start_handover}

    def metrics(self, cucp) -> dict:
        return {"nof_ues": len(cucp.ues), "ng_ready": cucp.ng_ready}


class DuF1Unit(ApplicationUnit):
    name = "du_f1"
    requires = ("cu_cp",)

    def build(self, ctx: Composition):
        from .l3.du_f1 import DuF1Sim

        cucp = ctx.instances["cu_cp"]
        du = DuF1Sim(send_to_cucp=cucp.rx_from_du)
        ctx.links["du_f1"] = du
        return du

    def metrics(self, du) -> dict:
        return {"f1_ready": du.f1_ready}


class CuUpE1Unit(ApplicationUnit):
    name = "cu_up_e1"
    requires = ("cu_cp",)

    def __init__(self, make_cu_up: Callable | None = None):
        self._make_cu_up = make_cu_up
        self.cu_ups: list = []

    def build(self, ctx: Composition):
        from .l3.cu_up_e1 import CuUpE1Agent

        cucp = ctx.instances["cu_cp"]
        make = self._make_cu_up or self._default_make
        e1 = CuUpE1Agent(send_to_cucp=cucp.rx_from_cuup, make_cu_up=make)
        ctx.links["cu_up_e1"] = e1
        return e1

    def _default_make(self, ue_id, keys, nea, nia):
        rec = _BearerRecorder(ue_id, keys, nea, nia)
        self.cu_ups.append(rec)
        return rec


class DuHighUnit(ApplicationUnit):
    name = "du_high"

    def register_config(self, schema: dict) -> None:
        schema.setdefault("scheduler", None)  # l2sim SchedulerConfig

    def build(self, ctx: Composition):
        from .l2.du_high_sim import DuHighSim
        from .l2sim.scheduler import SchedulerConfig

        sched_cfg = ctx.config.get("scheduler") or SchedulerConfig()
        return DuHighSim(sched_cfg)


class UpperPhyUnit(ApplicationUnit):
    name = "upper_phy"

    def register_config(self, schema: dict) -> None:
        schema.setdefault("phy", None)  # UpperPhyConfig

    def build(self, ctx: Composition):
        from .phy.upper_phy import UpperPhy, UpperPhyConfig

        cfg = ctx.config.get("phy") or UpperPhyConfig()
        return UpperPhy(cfg)


class _Rx:
    def __init__(self, fn):
        self.rx = fn


class _BearerRecorder:
    """Default CU-UP stand-in: records what E1 wired (apps supply a real
    CuUpSim factory via CuUpE1Unit(make_cu_up=...))."""

    def __init__(self, ue_id, keys, nea, nia):
        self.ue_id, self.keys, self.nea, self.nia = ue_id, keys, nea, nia
        self.pending_setup = None
        self.dl_teids = None

    def on_f1u_dl_teids(self, teids):
        self.dl_teids = teids


def compose_gnb(config: dict | None = None,
                make_cu_up: Callable | None = None,
                with_phy: bool = False) -> Composition:
    """The standard monolithic gNB composition (apps/gnb role)."""
    c = (Composer(config)
         .add(AmfUnit())
         .add(CuCpUnit())
         .add(DuF1Unit())
         .add(CuUpE1Unit(make_cu_up=make_cu_up))
         .add(DuHighUnit()))
    if with_phy:
        c.add(UpperPhyUnit())
    return c.compose()
