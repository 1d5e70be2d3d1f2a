"""The control: the reference put in the program's place, hashing with
MiMC7-90 where the configuration states MiMC7-91 (the guarantee a faster
round chain would be tempted to break).  Judged by the same comparison, it
must come out not correct, while the program's answers of the same run
come out correct.

The CPU test runs it at small shapes; the `card` test at each cell's own
size on three seeds, with a short window:

    python -m pytest -o addopts="" benchmark/test_bench_control.py -q -m card -s
"""

import json

import pytest

from benchmark import harness as H
from benchmark.conftest import small_config

CONTROL_ROUNDS = 90
CELLS = ["synth20.layer", "synth20.prove"]


@pytest.mark.parametrize("workload,config", [("synth20.layer", "synth20"),
                                             ("synth20.prove", "synth20"),
                                             ("synth20.prove", "matmul")])
def test_control_fails_small(bench, workload, config):
    out = H.run_cell(bench, workload, 2**31 + 99, 0.05, False, device="cpu",
                     config=small_config(config), control_rounds=CONTROL_ROUNDS)
    assert out["correct"] is True
    assert out["checks"]["mismatched_elements"]["value"] == 0
    assert out["control"]["mismatched_elements"] > 0


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 1001, 2**31 + 1002, 2**31 + 1003])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, bench, workload, seed):
    out = H.run_cell(bench, workload, seed, 2.0, False,
                     control_rounds=CONTROL_ROUNDS)
    print(json.dumps({"workload": workload, "seed": seed,
                      "program": out["checks"], "control": out["control"],
                      "attempted": out["attempted"]}))
    assert out["correct"] is True
    assert out["control"]["mismatched_elements"] > 0
