"""The plain reference agrees with the port on the CPU: every
micro-triangle's state and every entry of the serialized result, for
both bakers, on small atlases."""
import numpy as np
import pytest
import torch

import omm_tpu_torch as ot
from ommbench import check, inputs
from ommbench.reference import classify, finalize

from ommbench_cells import CELLS, SEED


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("size,quads,seed", [(256, 12, SEED),
                                             (512, 8, 11),
                                             (128, 24, 2 ** 33 + 1)])
def test_reference_agrees_with_the_port(small_cell, name, size, quads, seed):
    c = small_cell(name, size=size, quads=quads)
    cfg, entry = c["config"], c["entry"]
    gen = c["generator"].make(seed, cfg, c["traffic"]["params"], "cpu")
    plane = gen.textures[0]["mips"][0]
    state = entry.prepare(ot, cfg, torch.device("cpu"))
    tex = entry.texture(state, gen.textures[0])
    for i in range(2):
        uvs, idx = gen.mesh(inputs.TIMED, i)
        res = entry.call(state, entry.describe(state, tex, uvs, idx))
        ref = finalize.bake(plane, inputs.triangles(uvs, idx),
                            cfg["descriptor"], entry.BAKER)
        assert check.compare(ref, check.result_arrays(res)) == \
            {"states_wrong": 0, "layout_wrong": 0}
        assert check.requested(ref) > 0


def test_reference_dedups_and_promotes_like_the_cpu_baker(small_cell):
    """Repeated UVs, cards over empty and full texels: shared items,
    special indices and merged states, as the port lays them out."""
    c = small_cell(CELLS[0], size=64)
    cfg, entry = c["config"], c["entry"]
    plane = torch.zeros(64, 64)
    plane[:, 32:] = 1.0
    plane[40:50, 5:15] = 0.75
    tri = np.array([[[0.05, 0.05], [0.05, 0.2], [0.2, 0.05]],   # empty
                    [[0.6, 0.6], [0.6, 0.9], [0.9, 0.6]],       # full
                    [[0.375, 0.125], [0.375, 0.375], [0.625, 0.125]],  # edge
                    [[0.6, 0.1], [0.6, 0.3], [0.8, 0.1]],       # full
                    [[0.375, 0.125], [0.375, 0.375], [0.625, 0.125]],
                    [[0.05, 0.55], [0.05, 0.85], [0.3, 0.55]],  # block
                    # the edge moved by 32 texels along it: equal states
                    [[0.375, 0.625], [0.375, 0.875], [0.625, 0.625]]],
                   np.float32)
    uvs = tri.reshape(-1, 2)
    idx = np.arange(len(uvs), dtype=np.uint32)
    state = entry.prepare(ot, cfg, torch.device("cpu"))
    tex = entry.texture(state, {"format": "FP32", "mips": [plane]})
    res = entry.call(state, entry.describe(state, tex, uvs, idx))
    ref = finalize.bake(plane, tri, cfg["descriptor"], entry.BAKER)
    ib = ref["index_buffer"].tolist()
    assert ib[0] == -1 and ib[1] == ib[3] == -2
    assert ib[2] == ib[4] >= 0 and ib[5] >= 0 and ib[5] != ib[2]
    assert np.array_equal(ref["tri_states"][2], ref["tri_states"][6])
    # the CPU baker merges equal states; the GPU baker does not
    assert ib[6] == ib[2]
    gpu = finalize.bake(plane, tri, cfg["descriptor"], "gpu")
    assert gpu["index_buffer"][6] != gpu["index_buffer"][2]
    assert check.compare(ref, check.result_arrays(res)) == \
        {"states_wrong": 0, "layout_wrong": 0}


@pytest.mark.parametrize("level", [0, 1, 3, 6])
def test_bird_corners_cover_the_triangle(level):
    """The micro-triangles tile the unit triangle: their areas sum to
    its area and their corners stay inside it."""
    b = classify.bary_corners(level, "cpu").double()
    assert b.shape == (4 ** level, 3, 2)
    e1 = b[:, 1] - b[:, 0]
    e2 = b[:, 2] - b[:, 0]
    area = 0.5 * (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
    assert abs(float(area.sum()) - 0.5) < 1e-9
    assert float(b.min()) >= 0.0 and float(b.sum(-1).max()) <= 1.0
