"""``chip_smoke.py`` phases 2 and 3 (band and small-OPF solves through
``optimize()``, cold + warm) at tiny sizes on the CPU, against the pinned
oracles.  Kept apart from test_chip_smoke.py so the two files run on
separate test workers."""
import chip_smoke


def test_quad40_band_phase():
    r = chip_smoke.phase2(n=40, oracle=chip_smoke.ORACLES["quad-40"])
    assert r.status == "first_order"


def test_opf10_phase():
    r = chip_smoke.phase3(n=10, oracle=chip_smoke.ORACLES["opf-10"])
    assert r.status == "first_order"
