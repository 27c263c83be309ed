"""The comparison that decides `correct` fails what it has to fail: the
control (the reference on the atlas rounded to bfloat16), and a run
whose timed path is broken underneath, once for each fault a cell can
have; and a sound run passes."""
import copy
import io

import numpy as np
import pytest

from ommbench import check, control, run

from ommbench_cells import CELLS, SEED


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [SEED, 5, 2 ** 31 + 77])
def test_control_is_not_correct(small_cell, name, seed):
    c = small_cell(name, size=512, quads=32)
    r = control.readings(c, seed, "cpu")
    assert r["states_wrong"] > check.LIMITS["states_wrong"]
    assert r["layout_wrong"] > check.LIMITS["layout_wrong"]


def _flip_state(res):
    """One micro-triangle's state changed where the bake produced it."""
    res = copy.copy(res)
    data = np.array(res.array_data, copy=True)
    if len(res.desc_array):
        data[res.desc_array[0].offset] ^= 0x1
        res.array_data = data
    else:
        ib = np.array(res.index_buffer, copy=True)
        ib[0] = -1 if ib[0] != -1 else -2
        res.index_buffer = ib
    return res


def _half_left_out(res):
    """Half of the bake's triangles never classified."""
    res = copy.copy(res)
    ib = np.array(res.index_buffer, copy=True)
    ib[: len(ib) // 2] = -4
    res.index_buffer = ib
    return res


def _stale(call):
    """Each bake answered with the previous bake's result."""
    last = []

    def stale(state, inp):
        res = call(state, inp)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return stale


def _wrap(change):
    def wrapper(call):
        return lambda state, inp: change(call(state, inp))
    return wrapper


FAULTS = {"flip_state": _wrap(_flip_state),
          "half_left_out": _wrap(_half_left_out),
          "stale_result": _stale}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_run_fails_a_broken_timed_path(small_cell, name, fault):
    c = small_cell(name, size=256, quads=12, traced=3)
    # every sampled bake completes inside the window
    c["traffic"]["check"]["bakes"] = 3
    out = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0,
                       call_wrapper=FAULTS.get(fault))
    assert out["attempted"] == 3 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["check"]
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(check.LIMITS)


def test_missing_bakes_count_against_correct(small_cell):
    """A sampled bake that raised reads as wrong."""
    c = small_cell(CELLS[0], size=256, quads=12, traced=2)
    c["traffic"]["check"]["bakes"] = 2
    # the warm-up bakes come first; the timed bake 1 is the call after
    # the warm-up's and the timed bake 0's
    planted = int(c["traffic"]["warmup"]["bakes"]) + 1
    calls = []

    def raise_on_bake_1(call):
        def f(state, inp):
            calls.append(1)
            if len(calls) - 1 == planted:
                raise RuntimeError("planted failure")
            return call(state, inp)
        return f
    out = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0,
                       call_wrapper=raise_on_bake_1, log=io.StringIO())
    assert out["failed"] == 1
    assert out["correct"] is False
    assert out["check"]["states_wrong"]["value"] > 0
