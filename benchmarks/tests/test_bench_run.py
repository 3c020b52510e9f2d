"""Whole runs of each cell on the CPU at the test size (tiny.py): sound
runs come out correct; the control (the reference in the precision below
the configuration's, in the program's place) and each fault that the
cell's entry lists (faults.py: an answer altered where it is produced, a
training state left unchanged, half the batch left out) come out not
correct, against the cell's own limits."""
import importlib
import time

import pytest
import torch

import tiny
import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def _run(cell, trace=False):
    co, mo = tiny.overrides(cell)
    return harness.run_cell(cell, tiny.SEED, 0.5, trace, time.perf_counter(), device="cpu",
                            config_overrides=co, mix_overrides=mo)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert out["device"]["window_s"] > 0


def _control_numbers(cell):
    import control

    co, mo = tiny.overrides(cell)
    mode = harness.load_cell(cell).workload["control"]
    if mode == "tf32":
        pytest.skip("TF32 exists only on the card: the float32 control runs under the cuda marker")
    (seed, prog, ctrl, _), = control.readings(cell, [tiny.SEED], 1, device="cpu",
                                           config_overrides=co, mix_overrides=mo)
    return prog, ctrl


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    prog, ctrl = _control_numbers(cell)
    limits = harness.load_cell(cell).workload["limits"]
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctrl[k] > limits[k] for k in limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import control

    limits = harness.load_cell(cell).workload["limits"]
    (seed, prog, ctrl, _), = control.readings(cell, [tiny.SEED], 1)
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctrl[k] > limits[k] for k in limits), ctrl


def _entry(cell):
    c = harness.load_cell(cell)
    return getattr(c.config_module, c.mix.get("entry", "Program"))


FAULTS = [(c, f) for c in CELLS for f in _entry(c).faults()]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """Each fault that the cell's entry lists, planted in the port where the
    answer or the state is produced."""
    module, name, wrap = _entry(cell).faults()[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    out = _run(cell)
    assert not out["correct"], out["compared"]
