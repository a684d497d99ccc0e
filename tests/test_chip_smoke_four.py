"""``chip_smoke.py --four`` rehearsed on four of the virtual CPU devices at
tiny sizes: the scenario-sharded (farmer) and band-sharded (quadrotor)
solves must engage their shard_map-aligned KKT and match one device."""
import chip_smoke


def test_phase_four_tiny():
    chip_smoke.phase_four(farmer_n=64, quad_n=40, ndev=4)
