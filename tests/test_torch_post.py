"""omm_tpu_torch's fused post pass on packed rows against the JAX
package's: `native.row_post_packed` (each row's 3-state XXH64 digest and
uniform value) against `omm_tpu.native.row_post_packed` and against the
unpacked rows' `states3_digest` and `all_uniform_u8`; the batch
pipeline's `post_out` against `omm_tpu.kernels.twophase`'s (Pallas in
interpret mode) on the discovery path and the capacity chain, partial
batches included; bakes whose promotion and exact dedup read the posts,
byte-equal to the numpy oracle and to the same items with the posts
stripped; the invalidation of a post when states change, and the
profiler labels that split omm.finalize.  All comparisons are exact."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
from omm_tpu import native as jnative  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import batch, convert  # noqa: E402
from omm_tpu_torch import native as tnative  # noqa: E402
from omm_tpu_torch.twophase import PackedStates  # noqa: E402
from omm_tpu_torch.types import Format  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from test_torch_twophase import _cfg, port_inputs  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

# the module, not the function the package exports under the same name
tbake = importlib.import_module("omm_tpu_torch.bake")

UO = 3
UNIFORM_BYTES = (0x00, 0x55, 0xAA, 0xFF)  # a row of state 0, 1, 2, 3


def _unpack(blk, M):
    """Sequential 2-bit rows -> (rows, M) states, in plain numpy."""
    sh = np.arange(4, dtype=np.uint8) * 2
    return ((blk[:, :, None] >> sh) & 3).reshape(blk.shape[0], M)


def _rows(M, seed):
    """Seeded packed rows: random ones, a uniform row of each state, and
    near-uniform rows (one state off at the first, a middle and the
    last micro-triangle)."""
    rng = np.random.RandomState(seed)
    Q = M // 4
    rows = [rng.randint(0, 256, size=Q).astype(np.uint8) for _ in range(4)]
    for b in UNIFORM_BYTES:
        rows.append(np.full(Q, b, np.uint8))
    for b, j in zip(UNIFORM_BYTES, (0, M // 2 + 1, M - 1, M // 3)):
        r = np.full(Q, b, np.uint8)
        s = (b & 3) ^ (1 + j % 3)  # another state
        r[j >> 2] = (r[j >> 2] & ~np.uint8(3 << 2 * (j & 3))) \
            | np.uint8(s << 2 * (j & 3))
        rows.append(r)
    # a row of UnknownTransparent and UnknownOpaque only: one digest
    # with the uniform UnknownOpaque row in the 3-state view
    rows.append(rng.choice([0xAA, 0xFF, 0xBA, 0xEF], size=Q).astype(
        np.uint8))
    return np.stack(rows)


@pytest.mark.parametrize("M", [4, 16, 4 ** 5, 4 ** 7])
def test_row_post_packed_matches_jax_and_unpacked(M):
    """Equal to the JAX package's row_post_packed, and to states3_digest
    and all_uniform_u8 of each unpacked row."""
    blk = _rows(M, seed=M)
    dig, uni = tnative.row_post_packed(blk, M)
    jdig, juni = jnative.row_post_packed(blk, M)
    assert dig.dtype == np.uint64 and uni.dtype == np.int32
    assert np.array_equal(dig, jdig) and np.array_equal(uni, juni)
    unp = _unpack(blk, M)
    for r in range(blk.shape[0]):
        assert int(dig[r]) == jnative.states3_digest(unp[r]), r
        assert int(uni[r]) == jnative.all_uniform_u8(unp[r]), r
    assert sorted(int(u) for u in uni[4:8]) == [0, 1, 2, 3]
    assert (uni[8:12] == -1).all()


@pytest.mark.parametrize("M", [16, 4 ** 5])
def test_row_post_packed_row_base(M):
    """Rows scattered inside a blob (row_base): equal to the JAX
    package's over the same blob and to the compact block's posts."""
    blk = _rows(M, seed=7 + M)
    Q = M // 4
    rng = np.random.RandomState(M)
    order = rng.permutation(blk.shape[0])
    order = np.concatenate([order, order[:2]])  # rows read twice
    gaps = rng.randint(0, 9, size=blk.shape[0])
    base = np.concatenate([[0], np.cumsum(Q + gaps)[:-1]]) + 3
    blob = rng.randint(0, 256, size=int(base[-1]) + Q + 5).astype(np.uint8)
    for r in range(blk.shape[0]):
        blob[base[r]:base[r] + Q] = blk[r]
    rb = base[order].astype(np.int64)
    dig, uni = tnative.row_post_packed(blob, M, row_base=rb)
    jdig, juni = jnative.row_post_packed(blob, M, row_base=rb)
    assert np.array_equal(dig, jdig) and np.array_equal(uni, juni)
    cdig, cuni = tnative.row_post_packed(blk, M)
    assert np.array_equal(dig, cdig[order])
    assert np.array_equal(uni, cuni[order])


@pytest.mark.parametrize("M", [1, 2, 8, 32])
def test_row_post_packed_refuses_other_sizes(M):
    """M must be a power of 4 of at least 4: at M = 1 the C pass reads a
    1-state row holding 1 or 3 as not uniform, and its digest differs
    from states3_digest's; the port raises where the JAX package never
    calls it."""
    blk = np.full((2, max(M // 4, 1)), 0x55, np.uint8)
    with pytest.raises(ValueError):
        tnative.row_post_packed(blk, M)


def test_row_post_packed_refuses_rows_outside():
    """A block whose rows are not M/4 bytes, or a row_base row that ends
    past the buffer, raises before the C pass reads out of bounds."""
    blk = np.zeros((3, 4), np.uint8)
    with pytest.raises(ValueError):
        tnative.row_post_packed(blk, 64)
    with pytest.raises(ValueError):
        tnative.row_post_packed(blk.reshape(-1), 16, row_base=[0, 9])


def _interp_pallas(monkeypatch):
    """tests/test_twophase.py's: the JAX package's Pallas kernel in
    interpret mode on the CPU."""
    import jax.experimental.pallas as plmod
    import omm_tpu.kernels.pallas_classify as pk

    orig = plmod.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)


def _tris(n, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        out.append(np.array([b + [0.05, 0.08], b + [0.12, 0.7],
                             b + [0.72, 0.6]], np.float32))
    return out


def _batches(case, subdiv):
    """Two batches of 2 items: all fresh, or each a fresh item beside
    one with states resolved by an earlier pass."""
    M = omm.get_num_micro_triangles(subdiv)
    tris = _tris(4, seed=11)
    if case == "fresh":
        return [[(t, None) for t in tris[k:k + 2]] for k in (0, 2)]
    out = []
    for k in (0, 2):
        st = np.full(M, UO, np.uint8)
        st[k % 2::3] = 0
        out.append([(tris[k], None), (tris[k + 1], st)])
    return out


def _states(r):
    return r.unpack() if isinstance(r, PackedStates) else r


@pytest.mark.parametrize("case", ["fresh", "partial"])
def test_post_out_matches_jax(case, monkeypatch):
    """The same batches through both packages twice: the first call
    discovers, the second takes the capacity chain.  The port's post_out
    has a post on both paths for every row that comes back whole (all of
    a fresh batch, the fresh items of a partial one) and none for a row
    merged into prior states; each equals the recompute on its returned
    states, and every post the JAX package gives is equal in the
    port."""
    _interp_pallas(monkeypatch)
    subdiv = 5
    tex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    cfg = _cfg()
    ptex, pcfg = port_inputs(tex, cfg)
    jposts, pposts = [], []
    for k, path in enumerate(("discovery", "spec")):
        q = []
        tp.classify_work_items_batches(tex, cfg, _batches(case, subdiv),
                                       subdiv, post_out=q, packed_out=True)
        jposts.append(q)
        p = []
        ot.reset_launches()
        got = batch.classify_work_items_batches(
            ptex, pcfg, _batches(case, subdiv), subdiv, device="cpu",
            post_out=p)
        pc = ot.pipeline_counts()
        assert pc[path] == 2 and pc["spec" if k == 0 else "discovery"] == 0
        pposts.append(p)
        assert len(p) == 2
        for items, res, pd in zip(_batches(case, subdiv), got, p):
            want = {i for i, (_, st) in enumerate(items) if st is None}
            assert set(pd) == want
            for i, r in enumerate(res):
                assert isinstance(r, PackedStates) == (case == "fresh")
                if i in pd:
                    st = _states(r)
                    assert pd[i] == (jnative.states3_digest(st),
                                     jnative.all_uniform_u8(st)), i
    assert pposts[0] == pposts[1]
    n_jax = 0
    for q in jposts:
        for jd, pd in zip(q, pposts[1]):
            for i, post in jd.items():
                assert pd[i] == post, i
                n_jax += 1
    assert n_jax > 0  # the JAX package's chain gave posts to compare


def test_no_post_out_runs_no_post_pass(monkeypatch):
    """Without post_out, neither path calls the post pass."""
    def refuse(*a, **k):
        raise AssertionError("post pass ran without post_out")

    monkeypatch.setattr(batch.native, "row_post_packed", refuse)
    subdiv = 5
    ptex, pcfg = port_inputs(
        omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32),
        _cfg())
    for path in ("discovery", "spec"):
        ot.reset_launches()
        batch.classify_work_items_batches(
            ptex, pcfg, _batches("fresh", subdiv), subdiv, device="cpu")
        assert ot.pipeline_counts()[path] == 2


# uniform, mixed and duplicate triangles on the 256^2 circle under Wrap;
# dyadic UVs, so that a copy shifted by one period has equal states
_A = [[0.90625, 0.90625], [0.9375, 0.90625], [0.90625, 0.9375]]  # opaque
_B = [[0.4375, 0.4375], [0.5625, 0.4375], [0.4375, 0.5625]]  # transparent
_C = [[0.8125, 0.40625], [0.96875, 0.5], [0.8125, 0.59375]]  # the rim
_E = [[0.0625, 0.5], [0.21875, 0.375], [0.21875, 0.625]]  # the rim
_C2 = [[0.8125 + 1 / 512, 0.40625], [0.96875 + 1 / 512, 0.5],
       [0.8125 + 1 / 512, 0.59375]]  # _C a half texel over
_TRIS = [_A, _B, _C, np.add(_C, [1, 0]), _E, np.add(_B, [0, 1]),
         np.add(_A, [1, 1]), _C2]

BAKES = {
    "default": {},
    "no_special_indices": dict(
        bake_flags=int(omm.BakeFlags.DisableSpecialIndices)),
    "near_duplicates": dict(
        bake_flags=int(omm.BakeFlags.EnableNearDuplicateDetection)),
    "rejection": dict(rejection_threshold=0.99),  # rejects the rim
}


def _post_descs(case):
    tc = np.concatenate([np.asarray(t, np.float32) for t in _TRIS])
    n = len(_TRIS)
    fields = dict(tex_coords=tc, index_buffer=np.arange(3 * n,
                                                        dtype=np.uint32),
                  index_count=3 * n, max_subdivision_level=6,
                  dynamic_subdivision_scale=0.0, alpha_cutoff=0.5,
                  **BAKES[case])
    planes = [standard_circle(256, 256)]
    wrap = omm.TextureAddressMode.Wrap
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat.FP32),
        runtime_sampler=omm.SamplerDesc(addressing_mode=wrap), **fields)
    return jdesc, convert.bake_input(planes, 1, addressing_mode=int(wrap),
                                     **fields)


def _assert_equal(a, b):
    ra, rb = convert.result_to_numpy(a), convert.result_to_numpy(b)
    assert ra.keys() == rb.keys()
    for k in ra:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


@pytest.mark.parametrize("case", sorted(BAKES))
def test_bake_with_posts_byte_equal(case):
    """Items classified with their posts (discovery, then the capacity
    chain) finalize byte-equal to the same items with the posts
    stripped, to ot.bake and to omm.bake(backend="numpy"): array data,
    descriptors, index buffer, histograms and stats.  The descriptor's
    uniform and shifted-copy triangles make promotion and exact dedup
    act on the posts."""
    jdesc, desc = _post_descs(case)
    want = omm.bake(jdesc, backend="numpy")
    opts = tbake.Options.from_flags(desc.bake_flags)
    for path in ("discovery", "spec"):
        sets = []
        for _ in range(2):
            if path == "discovery":
                setattr(desc.texture, batch.CAPS_ATTR, {})
            ot.reset_launches()
            sets.append(tbake.setup_work_items(desc, opts))
            tbake.classify_items(desc, opts, sets[-1], "cpu")
            assert ot.pipeline_counts()[path] == 1
        with_post, stripped = sets
        posts = [it.post for it in with_post]
        assert all(p is not None for p in posts)
        assert [it.post for it in stripped] == posts
        uni = sorted({p[1] for p in posts})
        assert uni[0] == -1 and len(uni) >= 3  # mixed and uniform rows
        assert len({p[0] for p in posts}) < len(posts)  # equal rows
        for it in stripped:
            it.post = None
        a = tbake.finalize_items(desc, opts, with_post)
        b = tbake.finalize_items(desc, opts, stripped)
        _assert_equal(a, b)
        _assert_equal(a, want)
    _assert_equal(ot.bake(desc, device="cpu"), want)
    if case != "no_special_indices":
        assert (np.asarray(want.index_buffer) < 0).any()  # promoted
    assert len(want.desc_array) < len(_TRIS)  # dedup fired


def test_workitem_post_cache_invalidation():
    """tests/test_core_units.py's invalidation test on the port's
    WorkItem: a post clears on any states reassignment (merges build new
    arrays), states under a live post are frozen, and a PackedStates
    item keeps its post until its states are reassigned."""
    WorkItem = tbake.WorkItem
    tri = np.zeros((3, 2), np.float32)
    a = WorkItem(subdivision_level=2, vm_format=Format.OC1_4_State,
                 uv_tri=tri, primitive_indices=[0])
    b = WorkItem(subdivision_level=2, vm_format=Format.OC1_4_State,
                 uv_tri=tri, primitive_indices=[1])
    assert a._fresh and a.post is None
    with pytest.raises(ValueError):
        a.states[0] = 1
    a.post = (123, -1)
    b.post = (456, -1)
    with pytest.raises(ValueError):
        a.states[0] = 1
    st = a.states.copy()
    st[0] = 1
    a.states = st
    assert a.post is None and not a._fresh
    a.states[0] = 2
    a.post = (123, -1)
    b.states = np.zeros(16, np.uint8)
    tbake._merge_work_items(a, b)
    assert a.post is None and not a._fresh
    c = WorkItem(subdivision_level=2, vm_format=Format.OC1_4_State,
                 uv_tri=tri, primitive_indices=[2],
                 states=np.zeros(16, np.uint8))
    assert not c._fresh

    # a packed result with its post: reading states keeps the post (the
    # materialized array is frozen), reassigning them drops it
    row = np.array([0x55, 0x55, 0x55, 0x55], np.uint8)
    post = tuple(int(x[0]) for x in tnative.row_post_packed(row[None], 16))
    assert post[1] == 1
    tbake.set_states(c, PackedStates(row, 16), post)
    assert c.post == post and c.packed2() is not None
    assert (c.states == 1).all() and c.post == post
    with pytest.raises(ValueError):
        c.states[0] = 0
    c.states = np.zeros(16, np.uint8)
    assert c.post is None and c.packed2() is None


@pytest.mark.parametrize("same", [False, True], ids=["new", "identity"])
def test_set_states_installs_post_on_arrays(same):
    """set_states with an array: a new array replaces the states and
    then takes the post; the item's own array (an identity) keeps its
    states and takes the post; None leaves any post as it is."""
    it = tbake.WorkItem(subdivision_level=2, vm_format=Format.OC1_4_State,
                        uv_tri=np.zeros((3, 2), np.float32),
                        primitive_indices=[0],
                        states=np.ones(16, np.uint8))
    st = it.states if same else np.full(16, 1, np.uint8)
    post = (jnative.states3_digest(st), jnative.all_uniform_u8(st))
    tbake.set_states(it, st, post)
    assert it.states is st and it.post == post
    assert not st.flags.writeable
    tbake.set_states(it, st)
    assert it.post == post


def test_finalize_profiler_labels():
    """omm.finalize is split into its stages in torch.profiler, and the
    batch pipeline's post pass has its own label."""
    from torch.profiler import ProfilerActivity, profile
    _, desc = _post_descs("default")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ot.bake(desc, device="cpu")
    keys = {e.key for e in prof.key_averages()}
    for label in ("omm.classify", "omm.finalize", "omm.row_post",
                  "omm.promote", "omm.dedup_exact", "omm.dedup_near",
                  "omm.compress", "omm.histograms", "omm.sort",
                  "omm.serialize"):
        assert label in keys, label
