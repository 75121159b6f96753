"""The control, the reference put in the program's place and computed
through bfloat16, comes out not correct; at float32 it agrees with the
comparison exactly. The chip runs the same control at the cells' own size
(`python3 -m benchmark.control`)."""

import json

import pytest

from benchmark.tests.conftest import CELLS, TINY


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("low", [1, 0])
def test_control(capsys, cell, low):
    from benchmark import control

    capsys.readouterr()
    assert control.main(["--workload", cell, "--seeds", "2147483921", "--steps", "9",
                         "--low", str(low)], device="cpu", overrides=TINY) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if low:
        assert got["correct"] is False
        assert got["checks"]["grid_off"]["value"] > got["checks"]["grid_off"]["limit"]
        assert got["checks"]["raycast_off"]["value"] > got["checks"]["raycast_off"]["limit"]
    else:
        assert got["correct"] is True
        assert all(c["value"] == 0 for c in got["checks"].values())
