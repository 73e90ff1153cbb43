"""The check catches a broken program: a tiny run of each cell on the CPU
(the harness's look for a card skipped), with the timed path broken
underneath, comes out not correct under the cell's own limits:

- a step that returns its state unchanged (training);
- half of the batch left out, the mean taken over the rest (training: the
  image loss over half of the pixel rows, a step renders one view);
- an answer altered where it is produced (one tile of the render raised).

No exchange between chips exists in a one-chip cell, and a rendered frame
has no batch to halve and no state to leave unchanged. A sound tiny run
reads below every fault.
"""

from __future__ import annotations

import pytest

from benchmark import run as R
from benchmark.tests.conftest import tiny

CELLS = {"scaffold-train": ("scaffold_gs", "ScaffoldGSTrainer", "scaffold"),
         "scaffold-render": ("scaffold_gs", "ScaffoldGSTrainer", "scaffold")}
# a frame has no batch to halve and no state to leave unchanged
FAULTS = {"scaffold-render": ("altered",)}
ALL_FAULTS = ("unchanged", "half_batch", "altered")
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "alive_gap", "image_mae", "image_max")


def _break(monkeypatch, cell: str, fault: str):
    import importlib
    trainer_mod, trainer_cls, model_mod = CELLS[cell]
    T = importlib.import_module(f"triangle_splatting_tpu_torch.trainers.{trainer_mod}")
    cls = getattr(T, trainer_cls)
    if fault == "unchanged":
        orig = cls._train_step_dp

        def step(self, settings, params, opt, state, *a, **kw):
            out = orig(self, settings, params, opt, state, *a, **kw)
            return (params, opt, state) + tuple(out[3:])
        monkeypatch.setattr(cls, "_train_step_dp", step)
    elif fault == "half_batch":
        L = importlib.import_module("triangle_splatting_tpu_torch.trainers.losses")
        l1, ssim_loss = L.l1, L.ssim_loss
        monkeypatch.setattr(L, "l1", lambda a, b: l1(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2]))
        monkeypatch.setattr(L, "ssim_loss",
                            lambda a, b: ssim_loss(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2]))
    elif fault == "altered":
        M = importlib.import_module(f"triangle_splatting_tpu_torch.models.{model_mod}")
        fwd = M.forward

        def forward(*a, **kw):
            pkg = fwd(*a, **kw)
            img = pkg["render"].clone()
            img[:, :32, :32] = img[:, :32, :32] + 0.05
            pkg["render"] = img
            return pkg
        monkeypatch.setattr(M, "forward", forward)


CASES = [(c, f) for c in sorted(CELLS) for f in FAULTS.get(c, ALL_FAULTS)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, cell, fault)
    r = R.run_cell(cell, 424242424242, 0.2, False, "cpu", overrides=tiny)
    assert r["checks"].get("start_gap", {"value": 0.0})["value"] == 0.0
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_tiny_run_reads_below_every_fault(cell, monkeypatch):
    ok = R.run_cell(cell, 424242424242, 0.2, False, "cpu", overrides=tiny)["checks"]
    for fault in FAULTS.get(cell, ALL_FAULTS):
        with monkeypatch.context() as m:
            _break(m, cell, fault)
            bad = R.run_cell(cell, 424242424242, 0.2, False, "cpu", overrides=tiny)["checks"]
        assert any(bad[k]["value"] > 3 * ok[k]["value"] for k in NUMBERS if k in ok), (fault, ok, bad)
