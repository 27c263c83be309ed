"""The GPU baker's cell, `gpu_foliage4k.shared_atlas`, as BENCHMARK.json
enters it: `run.cell` finds its configuration, entry and metrics by
name, the GPU baker's own and those of the layers it shares with the
CPU cell; the metrics that read the GPU baker's spans and its
scratch-batch counter, each on run records made by hand (present,
absent, and the children of `gpu_unspanned_ms` in part); and a small
traced run of the cell on the CPU that reports every one of them."""
import os

import pytest

from ommbench import run

from ommbench_cells import ROOT, SEED

CELL = "gpu_foliage4k.shared_atlas"
SPANS = {"desc_patch_ms": "omm.desc_patch",
         "gpu_levels_ms": "omm.gpu.levels",
         "gpu_work_setup_ms": "omm.gpu.work_setup",
         "gpu_batches_ms": "omm.gpu.batches",
         "gpu_tail_ms": "omm.gpu.tail"}
NEW = (*SPANS, "gpu_unspanned_ms", "gpu_batches_per_dispatch")
#: the metrics of the layers the cell shares with the CPU cell (the batch
#: pipeline, the kernels, the device, a bake's latency) that read on a
#: small traced run on the CPU
SHARED_CPU = ("discovery_share", "count_syncs_per_bake", "class_planes_ms",
              "plan_ms", "post_wait_ms", "pinned_allocs_per_bake",
              "device_idle")
#: and those that need the card's trace or 20 bakes
SHARED_CHIP = ("bake_ms_p95_traced", "exact_kernel_ms", "chain_kernels_ms",
               "device_busy_ms")
#: the CPU baker's own, with nothing to read in the GPU baker's cell (the
#: GPU baker asks the batch pipeline for no posts, so no `omm.row_post`)
CPU_ONLY = ("setup_ms", "setup_levels_ms", "setup_dedup_ms", "finalize_ms",
            "classify_unspanned_ms", "row_post_ms")


def _metric(name):
    return run.load_file(os.path.join(ROOT, "ommbench", "metrics",
                                      name + ".py"), name)


def _run(labels_us=None, counts=None, bakes=4):
    r = {"bakes": bakes, "counts": counts if counts is not None else {}}
    if labels_us is not None:
        r["trace"] = {"labels_us": labels_us}
    return r


def test_the_entered_cell_loads_from_benchmark_json():
    bench = run.load_json(ROOT, "BENCHMARK.json")
    c = run.cell(bench, CELL)
    assert c["workload"]["chips"] == 1
    assert c["config"]["name"] == "gpu_foliage4k"
    assert c["config"]["reduced"] == []
    assert c["entry"].BAKER == "gpu"
    assert c["traffic"]["generator"] == "leaf_cards"
    assert {m["name"] for m, _ in c["end_to_end"]} == {
        "utri_per_s", "peak_mem_mib", "setup_s"}
    per = {m["name"]: m for m, _ in c["per_layer"]}
    assert set(per) == {*NEW, *SHARED_CPU, *SHARED_CHIP}
    for name in NEW:
        assert per[name]["layer"] == "GPU baker", name
        assert per[name]["workloads"] == [CELL], name
    for name, m in per.items():
        assert m["moves"] == "utri_per_s", name
    # the CPU cell reads none of the GPU baker's own, and every metric
    # of the layers the two share
    cpu = {m["name"] for m, _ in
           run.cell(bench, "cpu_foliage4k.shared_atlas")["per_layer"]}
    assert not set(NEW) & cpu
    assert cpu == {*SHARED_CPU, *SHARED_CHIP, *CPU_ONLY}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_metric_reads_ms_per_bake(name):
    m = _metric(name)
    assert m.SOURCE == "program_span"
    assert m.read(_run({SPANS[name]: 6000.0, "omm.gpu.dispatch": 9e9})) \
        == 1.5
    assert m.read(_run({"omm.gpu.dispatch": 6000.0})) is None
    assert m.read(_run()) is None
    assert m.read(_run({SPANS[name]: 6000.0}, bakes=0)) is None


def test_gpu_tail_reads_its_own_span():
    m = _metric("gpu_tail_ms")
    # the CPU tail's names, which the GPU tail opens inside its span and
    # the CPU baker inside omm.finalize, do not count
    cpu_tail = {"omm.histograms": 400.0, "omm.sort": 800.0,
                "omm.serialize": 2800.0}
    assert m.read(_run({"omm.gpu.tail": 4400.0, **cpu_tail})) \
        == pytest.approx(1.1)
    assert m.read(_run(cpu_tail)) is None
    assert m.read(_run({"omm.finalize": 5000.0, **cpu_tail})) is None


def test_gpu_unspanned_subtracts_the_children_present():
    m = _metric("gpu_unspanned_ms")
    assert m.SOURCE == "program_span"
    parents = {"omm.gpu.dispatch": 3000.0, "omm.gpu.execute": 5000.0}
    every = {c: 100.0 for c in m.CHILDREN}
    got = m.read(_run({**parents, **every}))
    assert got == pytest.approx((8000.0 - 100.0 * len(m.CHILDREN)) / 4e3)
    # children that are absent count 0; spans outside the list, such as
    # the batch pipeline's inside omm.gpu.batches and the CPU tail's
    # names inside omm.gpu.tail, do not count
    part = {**parents, "omm.gpu.levels": 2000.0, "omm.gpu.batches": 1000.0,
            "omm.plan": 3000.0, "omm.drain": 500.0, "omm.spec": 700.0,
            "omm.histograms": 300.0, "omm.sort": 200.0,
            "omm.serialize": 400.0}
    assert m.read(_run(part)) == pytest.approx(1.25)
    assert m.read(_run(parents)) == pytest.approx(2.0)
    assert m.read(_run({"omm.gpu.dispatch": 3000.0,
                        "omm.gpu.levels": 1000.0})) == pytest.approx(0.5)
    # a program without the baker's spans (the CPU baker, or a package
    # that lacks them) reads nothing
    assert m.read(_run({"omm.gpu.execute": 5000.0, **every})) is None
    assert m.read(_run({"omm.desc_patch": 100.0})) is None
    assert m.read(_run()) is None


def test_gpu_batches_per_dispatch_reads_the_counter():
    m = _metric("gpu_batches_per_dispatch")
    assert m.SOURCE == "program_counter"
    assert m.read(_run(counts={"gpu_batch": 6, "spec": 4})) == 1.5
    # a program that does not count them
    assert m.read(_run(counts={"spec": 4})) is None
    assert m.read(_run(counts={"gpu_batch": 0}, bakes=0)) is None


def test_a_traced_cpu_run_reports_the_new_metrics(small_cell):
    c = small_cell(CELL, size=256, quads=12, traced=3)
    c["traffic"]["check"]["bakes"] = 2
    out = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0)
    assert out["correct"] is True, out["check"]
    for name in (*NEW, *SHARED_CPU):
        assert name in out["metrics"], name
        assert out["metrics"][name]["value"] >= 0.0, name
    assert not set(CPU_ONLY) & set(out["metrics"])
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # a dispatch's triangles fit one scratch batch of the default budget
    assert got["gpu_batches_per_dispatch"] == 1.0
    # the children and what they leave out stay within the two parents
    parts = sum(got[k] for k in ("gpu_levels_ms", "gpu_work_setup_ms",
                                 "gpu_batches_ms", "desc_patch_ms",
                                 "gpu_tail_ms", "gpu_unspanned_ms"))
    # the spans cover at least 95% of the two parents, the guard the
    # cell's traced runs are held to on the chip
    assert got["gpu_unspanned_ms"] <= 0.05 * parts
