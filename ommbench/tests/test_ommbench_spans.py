"""The metrics that read the program's set-up and batch-pipeline spans
and its pinned-buffer counter: each on a run record made by hand (the
span or counter there, absent, and the children of `omm.classify` in
part), and all six in a small traced run of the cell on the CPU."""
import os

import pytest

from ommbench import run

from ommbench_cells import CELLS, ROOT, SEED

SPANS = {"setup_levels_ms": "omm.setup.levels",
         "setup_dedup_ms": "omm.setup.dedup",
         "plan_ms": "omm.plan",
         "post_wait_ms": "omm.post_wait"}
NEW = (*SPANS, "classify_unspanned_ms", "pinned_allocs_per_bake")


def _metric(name):
    return run.load_file(os.path.join(ROOT, "ommbench", "metrics",
                                      name + ".py"), name)


def _run(labels_us=None, counts=None, bakes=4):
    r = {"bakes": bakes, "counts": counts if counts is not None else {}}
    if labels_us is not None:
        r["trace"] = {"labels_us": labels_us}
    return r


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_metric_reads_ms_per_bake(name):
    m = _metric(name)
    assert m.SOURCE == "program_span"
    assert m.read(_run({SPANS[name]: 6000.0, "omm.setup": 9e9})) == 1.5
    assert m.read(_run({"omm.setup": 6000.0})) is None
    assert m.read(_run()) is None
    assert m.read(_run({SPANS[name]: 6000.0}, bakes=0)) is None


def test_classify_unspanned_subtracts_the_children_present():
    m = _metric("classify_unspanned_ms")
    assert m.SOURCE == "program_span"
    every = {c: 100.0 for c in m.CHILDREN}
    got = m.read(_run({"omm.classify": 8000.0, **every}))
    assert got == pytest.approx((8000.0 - 100.0 * len(m.CHILDREN)) / 4e3)
    # children that are absent count 0; spans outside the list do not
    # count
    part = {"omm.classify": 8000.0, "omm.drain": 2000.0,
            "omm.plan": 1000.0, "omm.spec": 3000.0, "omm.row_post": 500.0}
    assert m.read(_run(part)) == pytest.approx(1.25)
    assert m.read(_run({"omm.classify": 8000.0})) == pytest.approx(2.0)
    assert m.read(_run({"omm.drain": 2000.0})) is None
    assert m.read(_run()) is None


def test_pinned_allocs_per_bake_reads_the_counter():
    m = _metric("pinned_allocs_per_bake")
    assert m.SOURCE == "program_counter"
    assert m.read(_run(counts={"pinned_alloc": 12, "spec": 4})) == 3.0
    # a program that does not count them
    assert m.read(_run(counts={"spec": 4})) is None
    assert m.read(_run(counts={"pinned_alloc": 0}, bakes=0)) is None


def test_a_traced_cpu_run_reports_the_new_metrics(small_cell):
    c = small_cell(CELLS[0], size=256, quads=12, traced=3)
    c["traffic"]["check"]["bakes"] = 2
    named = [m["name"] for m, _ in c["per_layer"]]
    assert set(NEW) <= set(named)
    out = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0)
    assert out["correct"] is True, out["check"]
    for name in NEW:
        assert name in out["metrics"], name
        assert out["metrics"][name]["value"] >= 0.0, name
    # no pinned host memory on the CPU; the set-up's parts within it
    assert out["metrics"]["pinned_allocs_per_bake"]["value"] == 0.0
    assert out["metrics"]["setup_levels_ms"]["value"] \
        + out["metrics"]["setup_dedup_ms"]["value"] \
        <= out["metrics"]["setup_ms"]["value"]
