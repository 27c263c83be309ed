"""omm_tpu_torch.batch.classify_work_items_batches against the JAX
package's classify_work_items_batches (Pallas kernel in interpret mode)
and the numpy oracle engine.resample_fine_item, exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
from omm_tpu import engine  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
from omm_tpu_torch import batch  # noqa: E402
from omm_tpu_torch.twophase import PackedStates  # noqa: E402

from test_torch_twophase import (CASES, UO, _all_active, _cfg,  # noqa: E402
                                 _circle, _tris, port_inputs)
from torch_native_guard import jax_native_pinned  # noqa: E402,F401


def _oracle(tex, cfg, tri, subdiv, st):
    M = omm.get_num_micro_triangles(subdiv)
    return engine.resample_fine_item(
        tex, cfg, tri, subdiv, np.full(M, UO, np.uint8) if st is None
        else st.copy())


def _states(x):
    return x.unpack() if isinstance(x, PackedStates) else x


@pytest.mark.parametrize("case", sorted(CASES))
def test_classify_batches_match_jax_and_oracle(case):
    mk_tex, cfg, mk_items, subdiv = CASES[case]
    tex, items = mk_tex(), mk_items(subdiv)
    got = batch.classify_work_items_batches(*port_inputs(tex, cfg), [items],
                                            subdiv, device="cpu")[0]
    want = tp.classify_work_items_batches(
        tex, cfg, [[(t, None if st is None else st.copy())
                    for t, st in items]], subdiv)[0]
    assert all(isinstance(g, PackedStates) for g in got) == \
        _all_active(items)
    for (tri, st), g, w in zip(items, got, want):
        g = _states(g)
        assert np.array_equal(g, _states(w))
        assert np.array_equal(g, _oracle(tex, cfg, tri, subdiv, st))
        if st is not None:
            keep = st != UO
            assert np.array_equal(g[keep], st[keep])


def test_classify_batches_multi_level_and_resolved_items():
    """Two batches at two levels in one call; an item with nothing left
    to classify comes back as it was."""
    tex = _circle()
    cfg = _cfg()
    tris = _tris(3, seed=5)
    done = np.zeros(omm.get_num_micro_triangles(4), np.uint8)
    batches = [[(tris[0], None), (tris[1], done)], [(tris[2], None)]]
    got = batch.classify_work_items_batches(*port_inputs(tex, cfg), batches,
                                            [4, 6], device="cpu")
    assert got[0][1] is done
    for (b, sd) in ((0, 4), (1, 6)):
        g = _states(got[b][0])
        assert np.array_equal(g, _oracle(tex, cfg, batches[b][0][0], sd,
                                         None))
