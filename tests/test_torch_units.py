"""The port's application units against the JAX package's: ``compose_gnb``
builds the same units, links, config and metrics in both packages, the
attach runs through either composition with the same result, and a
missing dependency raises ``ValueError``.

One deliberate difference is pinned here (ROADMAP Q3): the port's
``ApplicationUnit.build`` is abstract, so a unit class without ``build``
fails when it is constructed; the reference's base ``build`` raises only
when ``compose`` calls it.  ``UpperPhyUnit`` builds the port's
``UpperPhy`` on its config's device.
"""

import pytest
import test_l3_attach as ref_attach
import test_units as ref_units
from test_torch_l3 import PORT as L3_PORT
from torch_parity import plain_state, reference_cases, run_on_port

from srsran_project_tpu import units as j_units
from srsran_project_tpu.l2 import security as j_sec
from srsran_project_tpu_torch import units as t_units
from srsran_project_tpu_torch.apps import ue_sim as t_ue
from srsran_project_tpu_torch.l2 import security as t_sec
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig


@pytest.mark.parametrize("module,name,kwargs", reference_cases(ref_units))
def test_reference_tests_on_port(monkeypatch, module, name, kwargs):
    """The reference's unit tests pass on the port's ``units`` (the attach
    test imports its UE agent from ``test_l3_attach`` inside the function)."""
    run_on_port(monkeypatch, module, name, kwargs, {**L3_PORT, "units": t_units},
                also=(ref_attach,))


def _composed(units, sec, ue_cls):
    comp = units.compose_gnb()
    amf, cucp, du = (comp.instances[k] for k in ("amf", "cu_cp", "du_f1"))
    shape = (list(comp.units), sorted(comp.links), sorted(comp.instances),
             plain_state(comp.config), {n: list(u.requires) for n, u in comp.units.items()},
             sorted(comp.commands()), plain_state(comp.metrics()))
    cucp.start(gnb_id=comp.config["gnb_id"], plmn=comp.config["plmn"], tac=comp.config["tac"])
    du.setup(cells=[{"pci": 1, "nr_cgi": "00101-1", "dl_arfcn": 632628, "bandwidth_rb": 48}])
    ue = ue_cls(du, c_rnti=0x4601,
                k_gnb_provider=lambda: sec.kdf(amf.k_amf, 0x6E, (1).to_bytes(4, "big")))
    ue.connect()
    after = (ue.state, amf.sessions_done, plain_state(comp.metrics()),
             plain_state([(c.ue_id, c.keys, c.nea, c.nia, c.dl_teids)
                          for c in comp.units["cu_up_e1"].cu_ups]))
    comp.commands()["cu_cp.release_ue"](1)
    return shape, after, ue.released, plain_state(comp.metrics())


def test_compose_gnb_matches_reference():
    """The same units in the same order, links, instances, config, requires,
    commands and metrics; the attach through each composition ends alike."""
    ref = _composed(j_units, j_sec, ref_attach.UeRrcAgent)
    port = _composed(t_units, t_sec, t_ue.UeRrcAgent)
    assert port == ref
    assert port[1][0] == "connected" and port[2]


def test_missing_dependency_raises():
    for units in (j_units, t_units):
        with pytest.raises(ValueError, match=r"unit du_f1 requires \['cu_cp'\]"):
            units.Composer().add(units.AmfUnit()).add(units.DuF1Unit()).compose()


def test_unit_without_build_fails_at_construction():
    """Deliberate difference: the port's ``build`` is abstract.  A unit
    class that does not define it cannot be constructed; the reference's
    fails only when the composition builds it."""
    class NoBuild(t_units.ApplicationUnit):
        name = "no_build"

    with pytest.raises(TypeError, match="abstract"):
        NoBuild()

    class RefNoBuild(j_units.ApplicationUnit):
        name = "no_build"

    composer = j_units.Composer().add(RefNoBuild())
    with pytest.raises(NotImplementedError):
        composer.compose()


def test_start_handover_command_is_the_cu_cps():
    """The CU-CP unit's ``start_handover`` command is the CU-CP's own
    method (mobility is a base of ``CuCpSim``), not a no-op stand-in."""
    comp = t_units.compose_gnb()
    cucp = comp.instances["cu_cp"]
    assert comp.commands()["cu_cp.start_handover"] == cucp.start_handover


def test_upper_phy_unit_builds_on_its_device():
    """``compose_gnb(with_phy=True)`` builds the port's ``UpperPhy`` on its
    config's device; the default config asks for the card."""
    assert UpperPhyConfig().device == "cuda"
    comp = t_units.compose_gnb({"phy": UpperPhyConfig(nof_ports=1, device="cpu")}, with_phy=True)
    phy = comp.instances["upper_phy"]
    assert type(phy).__module__ == "srsran_project_tpu_torch.phy.upper_phy"
    assert phy.device.type == "cpu" and list(comp.units)[-1] == "upper_phy"
