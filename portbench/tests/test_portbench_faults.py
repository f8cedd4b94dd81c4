"""The comparison that decides ``correct``, driven on the CPU at a small
size through each cell's own driver, with the harness's look for a card
skipped and the timed path broken underneath:

  * the program in float32 agrees with the plain reference far inside
    the limits (the reference computes what the port computes);
  * the control, the reference (training) or the program (evaluation)
    one precision below the configuration's, is not correct;
  * each fault the cell can have (``faults.py``) is not correct.
"""

import pytest

from portbench import check, faults
from portbench.drivers import train as train_driver
from portbench.reference import ds2, train as ref_train
from portbench import traffic, weights
from portbench.tests.small import cells, driver, small_cell

TRAIN = [c for c in cells() if small_cell(c).traffic["driver"] == "train"]
EVAL = [c for c in cells() if small_cell(c).traffic["driver"] == "eval"]


def judge(cell, numbers):
    return check.judge(numbers, cell.traffic["limits"])[0]


@pytest.mark.parametrize("workload", TRAIN + EVAL)
def test_float32_program_agrees_with_the_reference(workload):
    cell = small_cell(workload)
    key = "trainer.precision" if cell.traffic["driver"] == "train" else "model.precision"
    cell.traffic["port"] = [p for p in cell.traffic["port"] if not p.startswith(key)] + [
        f"{key}=32"]
    numbers = driver(cell).run(cell).numbers
    # float32 round-off only: the worst leaf's gradient norm is a sum over
    # every position of the batch, and after three steps Adam's sign steps
    # on round-off part the parameters by a few lr
    most = {"loss_gap": 1e-5, "grad_gap": 1e-3, "grad_dir_gap": 1e-4, "change_gap": 1e-2,
            "probs_gap": 1e-5, "beam_gap": 0.0, "beam_miss_share": 0.0}
    assert all(numbers[k] <= most[k] for k in numbers), numbers


@pytest.mark.parametrize("workload", TRAIN + EVAL)
def test_sound_run_is_correct(workload):
    cell = small_cell(workload)
    assert judge(cell, driver(cell).run(cell).numbers)


@pytest.mark.parametrize("workload", TRAIN)
def test_training_control_is_not_correct(workload):
    cell = small_cell(workload)
    tr = cell.traffic
    optim = train_driver.optim_settings(train_driver.port_config(cell, tr["batch"]))
    w0 = weights.make(cell.config, cell.seed, cell.device)
    batches = train_driver.ref_batches(traffic.generate(tr, cell.seed), tr["batch"],
                                       tr["checked_steps"], cell.device)
    exact = ref_train.train_steps(w0, cell.config, batches, optim)
    low = ref_train.train_steps(w0, cell.config, batches, optim, quant=ds2.fp8_quant)
    assert not judge(cell, check.train_numbers(low, exact))


@pytest.mark.parametrize("workload", EVAL)
def test_evaluation_control_is_not_correct(workload):
    cell = small_cell(workload)
    cell.traffic["port"] = [p for p in cell.traffic["port"]
                            if not p.startswith("model.precision")] + ["model.precision=16"]
    assert not judge(cell, driver(cell).run(cell).numbers)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_training_faults_are_not_correct(workload, fault):
    cell = small_cell(workload)
    with faults.train_fault(fault):
        assert not judge(cell, driver(cell).run(cell).numbers)


@pytest.mark.parametrize("workload", EVAL)
@pytest.mark.parametrize("fault", faults.EVAL_FAULTS)
def test_evaluation_faults_are_not_correct(workload, fault):
    cell = small_cell(workload)
    with faults.eval_fault(fault, cell.config["labels"]):
        assert not judge(cell, driver(cell).run(cell).numbers)
