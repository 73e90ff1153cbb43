"""The control of each cell, on the card at the cell's own size: the plain
reference put in the program's place with TF32 on (the configurations
state float32 with TF32 off) comes out not correct under the cell's
limits, and so do the planted faults (training: half of the batch left
out; both: the render altered where it is produced)."""

from __future__ import annotations

import json

import pytest

from benchmark import control as K
from benchmark.run import BENCH

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "alive_gap", "image_mae", "image_max")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["scaffold-train", "scaffold-render"])
def test_the_control_and_the_faults_are_not_correct(cell, cuda_device):
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    r = K.readings(cell, 5150515051505)
    for fault, got in r.items():
        assert any(got[k] > limits[k] for k in NUMBERS if k in got), (fault, got, limits)
