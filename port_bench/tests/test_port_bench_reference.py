"""The plain references against ``repro_torch`` at smoke size on the CPU,
through the drivers: one training run (three checked steps) and one
served run (prefill, then decode through the engine's cache) for each
configuration, in float32, where the two sides agree to round-off; and
every planted fault of a cell, in its own precision, comes out not
correct under the cell's limits."""

import pytest

from port_bench.tests.small import small_run

TRAIN, SERVE = "olmoe-train-s4096", "yi-serve-docs-c64"
# A served run is judged on requests that finished in its window: long
# enough for the smoke mix's longest (16 tokens) on a loaded CPU.
WINDOW = {TRAIN: 0.3, SERVE: 5.0}
F32 = {"compute_dtype": "float32", "param_dtype": "float32"}


def _f32(run):
    """The reference's products in float32, as the program's."""
    reference = run.cell.reference

    class F32Reference:
        def __getattr__(self, name):
            fn = getattr(reference, name)  # precision is the fifth argument
            return lambda *a: fn(*a[:4], "f32", *a[5:])

    run.cell.reference = F32Reference()
    return run


@pytest.mark.parametrize("config_of", [TRAIN, SERVE], ids=["olmoe", "yi"])
def test_one_training_run_agrees_with_the_reference(config_of):
    run = _f32(small_run(TRAIN, seconds=0.2, config_of=config_of, **F32))
    out = run.cell.driver.run(run)
    numbers = {k: v["value"] for k, v in out["checks"].items()}
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-4, numbers
    assert numbers["grad_diff"] < 1e-4, numbers
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("config_of", [TRAIN, SERVE], ids=["olmoe", "yi"])
def test_one_served_run_agrees_with_the_reference(config_of):
    # dropless experts: a prefill and the decode that follows it route as
    # the reference's one pass over the same tokens does
    run = _f32(small_run(SERVE, seconds=WINDOW[SERVE], config_of=config_of,
                         capacity_factor=4.0, **F32))
    out = run.cell.driver.run(run)
    numbers = {k: v["value"] for k, v in out["checks"].items()}
    assert numbers["served_mismatch"] == 0
    assert numbers["served_gap"] < 1e-4, numbers
    assert numbers["decode_logit_err"] < 1e-4, numbers
    samples = out["readings"]["samples"]
    assert len(samples) == 3
    for s in samples:  # every served token after the first was decoded and kept
        assert s["decoded_at"] == list(range(1, len(s["served"])))
    assert out["attempted"] >= 1 and out["failed"] == 0


# the number that each fault fails
CAUGHT_BY = {(TRAIN, "state_unchanged"): "grad_diff", (TRAIN, "half_batch"): "grad_diff",
             (SERVE, "state_unchanged"): "decode_logit_err",
             (SERVE, "token_altered"): "served_gap"}


@pytest.mark.parametrize("workload,fault", list(CAUGHT_BY))
def test_a_planted_fault_is_not_correct(workload, fault):
    run = small_run(workload, seconds=WINDOW[workload], fault=fault)
    out = run.cell.driver.run(run)
    assert out["correct"] is False, out["checks"]
    caught = out["checks"][CAUGHT_BY[workload, fault]]
    assert caught["value"] > caught["limit"], out["checks"]
    if workload == SERVE:  # judged on served requests, not for want of them
        assert out["readings"]["samples"]
