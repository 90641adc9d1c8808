"""A whole run on the CPU at a tiny size, past the look for a card: the
window drives the trainer's ``run_epoch`` at the fixed epoch and nothing
else of the recipe's loop; the plain reference agrees with the port's CPU
path; a run with a fault planted under the timed path comes out not
correct; on the card, the control (the reference in TF32) comes out not
correct at a size a test run holds."""

import pytest
import torch

from conftest import tiny_cell


def run_tiny(name, device, seconds=0.3, control=False, scene=None):
    import run
    return run.measure(tiny_cell(name, scene), 2 ** 33 + 7, seconds, False,
                       device, control=control)


def test_window_runs_epochs_at_the_fixed_epoch_only(cpu, monkeypatch):
    from edgegaussians_tpu_torch.train import trainer
    from port_bench.harness import program
    epochs = []
    orig = trainer.run_epoch

    def spy(state, epoch, *a, **k):
        epochs.append(epoch)
        return orig(state, epoch, *a, **k)

    def forbidden(*a, **k):
        raise AssertionError("the window ran the recipe's loop")

    monkeypatch.setattr(trainer, "run_epoch", spy)
    for name in ("run_density_control", "staged_growth", "save_checkpoint",
                 "train", "density_flags"):
        monkeypatch.setattr(trainer, name, forbidden)
    cell = tiny_cell("dtu.orient")
    out = run_tiny("dtu.orient", cpu, seconds=0.5)
    E = program.fixed_epoch(cell.recipe, cell.traffic)
    assert E == 450 and set(epochs) == {E}
    ctx = out["ctx"]
    # two set-up epochs, then the window's, each every view once
    assert len(epochs) == 2 + ctx["epochs"]
    assert ctx["view_steps"] == ctx["epochs"] * 6
    assert ctx["fires"] == ctx["view_steps"] // 5 or \
        ctx["fires"] == ctx["view_steps"] // 5 + 1


@pytest.mark.parametrize("name", ["dtu.early", "dtu.orient"])
def test_reference_agrees_with_the_port_on_the_cpu(cpu, name):
    got = run_tiny(name, cpu, seconds=0.0)["readings"]["program"]
    assert got["loss"] < 1e-5 and got["grad"] < 1e-3
    assert got["absgrad"] < 1e-3 and got["change"] < 0.05
    if "orient" in name:
        assert got["knn"] == 0.0 and got["moment"] < 0.2


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "nan_opacity"])
@pytest.mark.parametrize("name", ["dtu.early", "dtu.orient"])
def test_a_planted_fault_is_not_correct(cpu, name, fault):
    from port_bench.harness import compare, faults
    with faults.FAULTS[fault]():
        got = run_tiny(name, cpu, seconds=0.0)["readings"]["program"]
    assert not compare.verdict(got, tiny_cell(name).limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dtu.early", "dtu.orient"])
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 matmuls need the card")
    from port_bench.harness import compare
    scene = {"kind": "synthetic", "seed": 11, "views": 10, "width": 400,
             "height": 400, "lines": 8, "curves": 4}
    out = run_tiny(name, torch.device("cuda"), seconds=0.0, control=True,
                   scene=scene)["readings"]
    assert not compare.verdict(out["control"], tiny_cell(name).limits), \
        out["control"]
