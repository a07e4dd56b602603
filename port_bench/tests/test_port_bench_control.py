"""The control: the plain reference computed in fp8 (the precision below
the configurations' bf16) in the program's place has to come out as not
correct.  At the cells' own size that needs the card (``card``); at smoke
size on the CPU it reads well above the program on the same seed."""

import json
import time

import pytest

from port_bench import cell as cell_mod, checks
from port_bench.tests.small import ROOT, small_run

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROL_SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


def control_numbers(run) -> dict:
    numbers = run.cell.driver.control_numbers(run, "fp8")
    numbers.pop("readings")
    return numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct_at_the_cells_size(card, workload):
    cell = cell_mod.resolve(ROOT, workload)
    for seed in CONTROL_SEEDS:
        run = cell_mod.Run(cell=cell, seed=seed, seconds=12, trace=False,
                           t_start=time.perf_counter())
        correct, compared = checks.judge(control_numbers(run), cell.limits)
        assert not correct, (seed, compared)


@pytest.mark.parametrize("workload,number", [
    ("olmoe-train-s4096", "grad_diff"), ("yi-serve-docs-c64", "served_gap"),
    ("yi-serve-docs-c64", "decode_logit_err")])
def test_the_control_reads_above_the_program_at_smoke_size(workload, number):
    seconds = 5.0 if workload.startswith("yi-serve") else 0.3  # requests finish
    for seed in (11, 12):
        sound = small_run(workload, seed=seed, seconds=seconds)
        program = sound.cell.driver.run(sound)["checks"][number]["value"]
        control = control_numbers(small_run(workload, seed=seed, seconds=seconds))[number]
        assert control > 2 * program, (seed, program, control)
