"""omm_tpu_torch on a CUDA card: the hand-written exact kernel against
its torch twin (windows of up to and over 32 texels, periodic address
modes), the bake on the card (its default device) against the bake on
the CPU, the benchmark bake on the card against the JAX package's
numpy oracle, the GPU baker's dispatch on the card (default engine
and ComputeOnly) against the dispatch on the CPU, and the mesh bake
(every card; two slots on one card) against the plain bake, with kernel
launches from several threads all counted, and the library surface
(`Baker`, the CLI's bake) on the card against the CPU, and a batch's
capacity chain as a CUDA graph (its replays against the eager chain on
the CPU and the discovery path, also from several threads at once), and
the chain's descent and tile-slot kernels (`kernels.chain`) against
their plain versions on every call of a batch's discovery path, its
capacity chain and a forced overflow, with their launch counts, their
input checks and their build and launch errors.
The port's inputs are built through convert from the same numpy arrays
as the JAX package's.

Every test is marked `cuda` and skips without a card.  This file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import engine  # noqa: E402
from omm_tpu_torch import batch, convert, host  # noqa: E402
from omm_tpu_torch import engine as tengine  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402
from omm_tpu_torch.kernels import build, chain, exact  # noqa: E402
from omm_tpu_torch.twophase import slot_stream  # noqa: E402

from fixtures import sine_fp32, sine_unorm8, standard_circle  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(**over):
    """The port's ResampleConfig; enums as integer values."""
    base = dict(addr_mode=2, filter=1, alpha_cutoff=0.5, border_alpha=0.0,
                fmt=2, promotion=0, cutoff_gt=1, cutoff_le=0)
    base.update(over)
    types = dict(addr_mode=ttypes.TextureAddressMode,
                 filter=ttypes.TextureFilterMode, fmt=ttypes.Format,
                 promotion=ttypes.UnknownStatePromotion,
                 cutoff_gt=ttypes.OpacityState, cutoff_le=ttypes.OpacityState)
    return tengine.ResampleConfig(**{
        k: types[k](v) if k in types else v for k, v in base.items()})


def _tris(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        out.append(np.array([b + [0.05, 0.08], b + [0.12, 0.7],
                             b + [0.72, 0.6]], np.float32))
    return out


_PERIODIC = np.array([[0.1, -0.2], [0.2, 1.1], [1.3, 0.7]], np.float32)

CASES = {
    "clamp": (lambda: convert.texture([standard_circle(256, 256)], 1),
              _cfg(), lambda: _tris(8, 7), 7),
    "wrap": (lambda: convert.texture([sine_fp32(128, 128)], 1),
             _cfg(addr_mode=0), lambda: [_PERIODIC], 7),
    "mirror": (lambda: convert.texture([sine_fp32(128, 128)], 1),
               _cfg(addr_mode=1), lambda: [_PERIODIC[::-1].copy()], 7),
    "unorm8_2mip": (lambda: convert.texture(
        [sine_unorm8(128, 128), sine_unorm8(128, 128)[::2, ::2]], 0),
        _cfg(promotion=1), lambda: _tris(4, 3), 6),
    "wide_window": (lambda: convert.texture([standard_circle(256, 256)], 1),
                    _cfg(), lambda: _tris(4, 4), 4),
    "wrap_wide_window": (lambda: convert.texture([sine_fp32(128, 128)], 1),
                         _cfg(addr_mode=0), lambda: [_PERIODIC], 4),
}


def _streams(case, cuda):
    """The exact stage's (args, keyword arguments) of each mip of a
    CASES entry, from the port's stage_ab on the card."""
    mk_tex, cfg, mk_tris, subdiv = CASES[case]
    tex, tris = mk_tex(), mk_tris()
    pre = batch.precompute(tex, tris, subdiv,
                           host._group_level(tex, tris, subdiv))
    bp = batch.batch_planes(tex, cfg, pre, cuda)
    uv_flat, ccw = batch.item_tables(np.stack(tris), cuda)
    res = batch.run_stage_ab(bp, uv_flat, None, subdiv, True)
    out = []
    for mi in range(tex.mip_count):
        w, h = bp["mips"][mi]
        H, W = bp["HW"][mi]
        kw = dict(subdiv=subdiv, pad=bp["pads"][mi], ntx=bp["ntxs"][mi],
                  size=(w, h), period=bp["periods"][mi], H=H, W=W,
                  rcp=bp["rcps"][mi], alpha_cutoff=float(cfg.alpha_cutoff))
        bt, ids = slot_stream(uv_flat, res["ids"], res["slots"][mi],
                              res["padMs"][mi], subdiv=subdiv, w=w, h=h,
                              pad=kw["pad"], ntx=kw["ntx"],
                              period=kw["period"])
        out.append(((bp["planes"][mi], bt, ids, uv_flat, ccw), kw))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_twin(case, cuda):
    for args, kw in _streams(case, cuda):
        if "wide" in case:  # more pairs per slot than a chunk
            assert kw["H"] * kw["W"] > 32
        before = exact.LAUNCHES
        ka, kb = exact.exact_counts(*args, **kw)
        torch.cuda.synchronize()
        assert exact.LAUNCHES == before + 1
        ta, tb = exact.exact_counts(*args, exact="torch", **kw)
        assert exact.LAUNCHES == before + 1
        assert torch.equal(ka, ta) and torch.equal(kb, tb)
        assert ((ka + kb) > 1).any()


def test_kernel_empty_blocks_and_checked_reads(cuda):
    """Blocks of empty slots count 0, and a block whose tile does not
    hold its slots' windows reads through the checked fetch (0.0
    outside the region): the kernel equals the twin."""
    tex = convert.texture([standard_circle(256, 256)], 1)
    cfg, subdiv, tris = _cfg(), 6, _tris(3, 5)
    pre = batch.precompute(tex, tris, subdiv,
                           host._group_level(tex, tris, subdiv))
    bp = batch.batch_planes(tex, cfg, pre, cuda)
    uv_flat, ccw = batch.item_tables(np.stack(tris), cuda)
    res = batch.run_stage_ab(bp, uv_flat, None, subdiv, True)
    w, h = bp["mips"][0]
    H, W = bp["HW"][0]
    kw = dict(subdiv=subdiv, pad=bp["pads"][0], ntx=bp["ntxs"][0],
              size=(w, h), period=None, H=H, W=W, rcp=bp["rcps"][0],
              alpha_cutoff=0.5)
    bt, ids = slot_stream(uv_flat, res["ids"], res["slots"][0],
                          res["padMs"][0], subdiv=subdiv, w=w, h=h,
                          pad=kw["pad"], ntx=kw["ntx"])
    empty = torch.full((1, host.B), -1, dtype=torch.int32, device=cuda)
    ids2 = torch.cat([empty, ids, empty, ids]).contiguous()
    shifted = (bt + 1) % (kw["ntx"] ** 2)  # windows outside the region
    bt2 = torch.cat([bt[:1], bt, bt[:1], shifted]).contiguous()
    args = (bp["planes"][0], bt2, ids2, uv_flat, ccw)
    ka, kb = exact.exact_counts(*args, **kw)
    ta, tb = exact.exact_counts(*args, exact="torch", **kw)
    assert torch.equal(ka, ta) and torch.equal(kb, tb)
    n = ids.shape[0]
    assert not ka[0].any() and not ka[n + 1].any() and not kb[0].any()


@pytest.mark.parametrize("mode", list(omm.TextureAddressMode),
                         ids=lambda m: m.name)
def test_bake_on_card_equals_cpu(mode, cuda):
    rng = np.random.RandomState(42)
    tris = []
    for _ in range(8):
        base = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                              base + [0.7, 0.65]], np.float32))
    fields = dict(tex_coords=np.concatenate(tris), index_buffer=np.arange(
        24, dtype=np.uint32), index_count=24, alpha_cutoff=0.5,
        max_subdivision_level=7, dynamic_subdivision_scale=0.0)
    planes = [standard_circle(256, 256)]
    sampler = dict(addressing_mode=int(mode), filter=1, border_alpha=0.7)
    ot.reset_launches()
    got = ot.bake(convert.bake_input(planes, 1, **sampler, **fields),
                  device=cuda)
    assert ot.launches()["exact_classify"] > 0
    want = ot.bake(convert.bake_input(planes, 1, **sampler, **fields),
                   device="cpu")
    _assert_equal(got, want)


def _assert_equal(a, b):
    ra, rb = convert.result_to_numpy(a), convert.result_to_numpy(b)
    for k in ra:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


BENCH_TRIS, BENCH_SUBDIV = 256, 9


def _bench_desc(n):
    """The benchmark workload (bench.py's _workload): a 1024^2 FP32 clamp
    texture with a circle of radius 0.4, and its first n of 256
    triangles from RandomState(42), at subdivision 9; as the JAX
    package's descriptor and the port's, with the triangles."""
    w = h = 1024
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    r = np.sqrt((i / np.float32(w) - 0.5) ** 2
                + (j / np.float32(w) - 0.5) ** 2)
    plane = np.where(r < np.float32(0.4), np.float32(0.0),
                     np.float32(1.0)).astype(np.float32)
    plane[0, 0] = np.float32(0.6)
    rng = np.random.RandomState(42)
    tris = []
    for _ in range(BENCH_TRIS):
        base = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                              base + [0.7, 0.65]], np.float32))
    tris = tris[:n]
    fields = dict(tex_coords=np.concatenate(tris), index_buffer=np.arange(
        3 * n, dtype=np.uint32), index_count=3 * n, alpha_cutoff=0.5,
        max_subdivision_level=BENCH_SUBDIV, dynamic_subdivision_scale=0.0)
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture([plane], omm.TextureFormat.FP32), **fields)
    return jdesc, convert.bake_input([plane], 1, **fields), tris


def test_bench_bake_matches_numpy_oracle(cuda):
    """The whole benchmark bake on the card, its default device: the
    states of 8 fixed triangles equal the numpy oracle
    (engine.resample_fine_item), as the JAX package's parity gate checks
    them."""
    from omm_tpu.stats import decode_states
    jdesc, tdesc, tris = _bench_desc(BENCH_TRIS)
    ot.reset_launches()
    res = ot.bake(tdesc)
    assert ot.launches()["exact_classify"] > 0
    cfg = engine.ResampleConfig(
        addr_mode=omm.TextureAddressMode.Clamp,
        filter=omm.TextureFilterMode.Linear, alpha_cutoff=0.5,
        border_alpha=0.0, fmt=jdesc.format,
        promotion=jdesc.unknown_state_promotion,
        cutoff_gt=jdesc.alpha_cutoff_greater,
        cutoff_le=jdesc.alpha_cutoff_less_equal)
    M = 4 ** BENCH_SUBDIV
    for k in range(0, BENCH_TRIS, BENCH_TRIS // 8):
        want = engine.resample_fine_item(jdesc.texture, cfg, tris[k],
                                         BENCH_SUBDIV,
                                         np.full(M, 3, np.uint8))
        idx = int(res.index_buffer[k])
        if idx < 0:  # special index: uniform FullyTransparent(-1)..UO(-4)
            got = np.full(M, -idx - 1, np.uint8)
        else:
            d = res.desc_array[idx]
            assert d.subdivision_level == BENCH_SUBDIV
            got = decode_states(res.array_data, d.offset, BENCH_SUBDIV,
                                d.format)
        assert np.array_equal(got, want), k


def test_bench_bake16_equals_numpy_backend(cuda):
    """The first 16 benchmark triangles baked on the card (the default
    device) give a BakeResult byte-equal to the JAX package's numpy
    backend."""
    jdesc, tdesc, _ = _bench_desc(16)
    _assert_equal(ot.bake(tdesc), omm.bake(jdesc, backend="numpy"))


def test_wrapper_rejects_mixed_devices(cuda):
    plane = torch.zeros((200, 200), device=cuda)
    bt = torch.zeros(1, dtype=torch.int32)  # on the CPU
    ids = torch.full((1, host.B), -1, dtype=torch.int32, device=cuda)
    uv6 = torch.zeros((1, 6), device=cuda)
    ccw = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        exact.exact_counts(plane, bt, ids, uv6, ccw, subdiv=3, pad=70,
                           ntx=4, size=(64, 64), period=None, H=4, W=4,
                           rcp=(1 / 64, 1 / 64), alpha_cutoff=0.5)


_LINE = np.array([[0.2, 0.0], [0.2, 0.437582970], [0.2, 0.218791485]],
                 np.float32)
_SLIVER = np.array([[0.1, 0.3], [0.9, 0.3000001], [0.5, 0.3]], np.float32)
_WIDE = np.array([[0.02, 0.03], [0.97, 0.1], [0.4, 0.95]], np.float32)


def _route_fields(tris, subdiv, **more):
    n = len(tris)
    return dict(tex_coords=np.concatenate(tris).astype(np.float32),
                index_buffer=np.arange(3 * n, dtype=np.uint32),
                index_count=3 * n, alpha_cutoff=0.5,
                max_subdivision_level=subdiv,
                dynamic_subdivision_scale=0.0, **more)


ROUTE_CASES = {
    # sampler, triangles, subdivision, extra fields, routes that must run
    "nearest": (dict(filter=0), _tris(6, 9) + [_LINE], 7, {},
                ("nearest_phase1", "nearest_survivors", "host_engine")),
    "nearest_border_2state": (dict(filter=0, addressing_mode=3,
                                   border_alpha=0.7), _tris(4, 2), 6,
                              dict(format=1), ("nearest_survivors",)),
    "mixed_linear": (dict(filter=1), _tris(4, 1) + [_LINE, _SLIVER]
                     + _tris(2, 5) + [_WIDE], 7,
                     dict(subdivision_levels=np.array(
                         [7, 7, 7, 7, 7, 7, 0, 1, 2], np.uint8)),
                     ("fast_path", "degenerate", "linear_survivors",
                      "dense")),
    "aabb_testing": (dict(filter=1), _tris(4, 3), 6, dict(bake_flags=int(
        omm.BakeFlags.DisableLevelLineIntersection
        | omm.BakeFlags.EnableAABBTesting)), ("host_engine",)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routes_on_card_equal_cpu(case, cuda):
    """Each route off the fast path on the card (the bake's default
    device), byte-equal to the same bake on the CPU."""
    sampler, tris, sd, more, want = ROUTE_CASES[case]
    planes = [standard_circle(256, 256)]
    fields = _route_fields(tris, sd, **more)
    ot.reset_launches()
    got = ot.bake(convert.bake_input(planes, 1, **sampler, **fields))
    counts = ot.launches()
    for r in want:
        assert counts[f"route.{r}"] > 0, (r, counts)
    _assert_equal(got, ot.bake(convert.bake_input(planes, 1, **sampler,
                                                  **fields), device="cpu"))


def test_nearest_sides_on_card(cuda):
    """The nearest filter's phase-1 side map on the card equals the CPU's
    (same class planes, moved to the card)."""
    from omm_tpu_torch import twophase
    tex = convert.texture([standard_circle(256, 256)], 1)
    cfg = _cfg(filter=0)
    tris = _tris(3, 8)
    items = [(t, None) for t in tris]
    a = twophase.resolve_nearest_phase1(tex, cfg, items, 6, cuda)
    b = twophase.resolve_nearest_phase1(tex, cfg, items, 6, "cpu")
    assert a is not None
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("flags", [3, 3 | 4 | 8],
                         ids=["default", "compute_only"])
def test_gpu_dispatch_on_card_equals_cpu(flags, cuda):
    """gpu.Pipeline().dispatch(cfg) on the card (its default device),
    byte-equal, post-dispatch info included, to the dispatch on the CPU;
    the default engine launches the exact kernel, ComputeOnly never."""
    rgba = np.stack([standard_circle(256, 256), sine_fp32(256, 256),
                     standard_circle(256, 256).T.copy(),
                     sine_fp32(256, 256).T.copy()], axis=-1)
    tris = _tris(6, 11) + [_LINE]
    fields = dict(_route_fields(tris, 7), alpha_texture_channel=2,
                  bake_flags=flags)
    ot.reset_launches()
    got = ot.gpu.Pipeline().dispatch(
        convert.dispatch_config([rgba], 1, **fields)).execute()
    launched = ot.launches()
    assert launched["route.fast_path"] == 6
    assert launched["route.degenerate"] == 1
    assert (launched["exact_classify"] > 0) == (flags == 3)
    want = ot.gpu.Pipeline().dispatch(
        convert.dispatch_config([rgba], 1, **fields), device="cpu").execute()
    _assert_equal(got[0], want[0])
    assert convert.post_to_dict(got[1]) == convert.post_to_dict(want[1])


@pytest.mark.parametrize("mesh", [None, ["cuda:0", "cuda:0"]],
                         ids=["all_cards", "two_slots_one_card"])
def test_mesh_bake_on_card_equals_plain(mesh, cuda):
    """ot.bake over a mesh on the card (every card; two slots, two
    threads, on cuda:0) is byte-equal to the plain bake on the card, with
    the same exact launches (64 bench triangles: one batch of 48 and one
    of 16, or 32 + 32 per slot)."""
    _, tdesc, _ = _bench_desc(64)
    ot.reset_launches()
    want = ot.bake(tdesc)
    plain = ot.launches()
    ot.reset_launches()
    got = ot.bake(tdesc, mesh=ot.parallel.make_mesh(mesh))
    counts = ot.launches()
    _assert_equal(got, want)
    assert counts["route.fast_path"] == plain["route.fast_path"] == 64
    assert counts["exact_classify"] == plain["exact_classify"] == 2


def test_kernel_launches_add_up_across_threads(cuda):
    """Eight threads launching the exact kernel on one card: every launch
    counts, and every result equals the twin's."""
    import concurrent.futures as cf

    (args, kw), = _streams("clamp", cuda)
    ta, tb = exact.exact_counts(*args, exact="torch", **kw)

    def run(_):
        outs = [exact.exact_counts(*args, **kw) for _ in range(25)]
        torch.cuda.current_stream(cuda).synchronize()
        return all(torch.equal(a, ta) and torch.equal(b, tb)
                   for a, b in outs)

    ot.reset_launches()
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(run, range(8)))
    assert ot.launches()["exact_classify"] == 8 * 25


def test_surface_on_card_equals_cpu(cuda, tmp_path, capsys):
    """ot.Baker().bake(desc) and the CLI's bake on the card (their
    default) launch the exact kernel and are byte-equal to the CPU's,
    the CLI's printed JSON and written blob included."""
    from omm_tpu_torch import cli
    _, tdesc, _ = _bench_desc(16)
    ot.reset_launches()
    got = ot.Baker().bake(tdesc)
    assert ot.launches()["exact_classify"] > 0
    _assert_equal(got, ot.Baker().bake(tdesc, device="cpu"))
    p = tmp_path / "in.bin"
    p.write_bytes(ot.Baker().serialize(input_descs=[tdesc]))
    outs = []
    for extra in ([], ["--device", "cpu"]):
        q = tmp_path / f"out{len(extra)}.bin"
        ot.reset_launches()
        assert cli.main(["bake", "--input-blob", str(p), "--out", str(q)]
                        + extra) == 0
        assert (ot.launches()["exact_classify"] > 0) == (not extra)
        outs.append((capsys.readouterr().out.replace(str(q), "OUT"),
                     q.read_bytes()))
    assert outs[0] == outs[1]


def _spec_job(case, device, exact_engine=None, tris=None):
    """A fresh-item batch of a CASES entry on `device`, on the case's
    shared texture (whose caps cache and graphs carry over between
    jobs)."""
    mk_tex, cfg, mk_tris, subdiv = CASES[case]
    tex = _SPEC_TEX.setdefault(case, mk_tex())
    tris = mk_tris() if tris is None else tris
    pre = batch.precompute(tex, tris, subdiv,
                           host._group_level(tex, tris, subdiv))
    job = batch._Batch(tex, cfg, [(t, None) for t in tris], subdiv,
                       list(range(len(tris))), [None] * len(tris), True, pre,
                       torch.device(device), exact_engine)
    return job


_SPEC_TEX: dict = {}


def _rows(out):
    return [o.packed for o in out]


@pytest.mark.parametrize("exact_engine", [None, "torch"],
                         ids=["kernel", "twin"])
@pytest.mark.parametrize("case", ["clamp", "unorm8_2mip", "wrap"])
def test_graph_replay_equals_eager_and_discovery(case, exact_engine, cuda):
    """A batch's capacity chain as a CUDA graph: the first call (the
    warm-up on a side stream, then the capture) and two replays give
    the payload of the eager chain on the CPU, and rows equal to the
    discovery path's; each replay counts the graph's exact launches
    (one per mip with the kernel, none with the twin)."""
    _SPEC_TEX.pop(case, None)
    disc = _spec_job(case, cuda, exact_engine)
    batch._run_batch(disc)
    _, want, _ = batch._enqueue_spec(_spec_job(case, "cpu"))
    ot.reset_launches()
    jobs = [_spec_job(case, cuda, exact_engine) for _ in range(3)]
    pending = [batch._enqueue_spec(j) for j in jobs]
    counts = ot.launches()
    pc = ot.pipeline_counts()
    assert pc["graph_capture"] == 1
    assert pc["graph_replay"] == 2
    nmip = disc.texture.mip_count
    assert counts["exact_classify"] == (3 * nmip if exact_engine is None
                                        else 0)
    for j, p in zip(jobs, pending):
        p[2].synchronize()
        assert torch.equal(p[1], want)
        rows = batch._drain_spec(j, p)
        assert rows is not None
        j.write_back(rows)
        assert all(np.array_equal(a, b)
                   for a, b in zip(_rows(j.out), _rows(disc.out)))


def test_graph_replays_from_threads(cuda):
    """Eight threads replay one texture's graphs at once (two batches of
    other items, one graph each shape): each payload equals the eager
    chain's on the CPU, and every replay's launches count."""
    import concurrent.futures as cf

    _SPEC_TEX.pop("clamp", None)
    sets = [_tris(8, 7), _tris(8, 11)]
    for s in sets:
        batch._run_batch(_spec_job("clamp", cuda, tris=s))
    want = [batch._enqueue_spec(_spec_job("clamp", "cpu", tris=s))[1]
            for s in sets]
    for s in sets:  # the captures
        batch._enqueue_spec(_spec_job("clamp", cuda, tris=s))[2].synchronize()

    def run(k):
        ok = True
        for r in range(6):
            s = (k + r) % 2
            _, buf, ev = batch._enqueue_spec(_spec_job("clamp", cuda,
                                                       tris=sets[s]))
            ev.synchronize()
            ok &= torch.equal(buf, want[s])
        return ok

    ot.reset_launches()
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(run, range(8)))
    counts = ot.launches()
    pc = ot.pipeline_counts()
    assert pc["graph_replay"] == 48
    assert counts["exact_classify"] == 48


# ---------------------------------------------------------------------------
# the capacity chain's kernels
# ---------------------------------------------------------------------------

def _chain_job(case, cuda, partial):
    """A batch of a CASES entry on the card, fresh or partial (a third
    of each item's micro-triangles already resolved)."""
    mk_tex, cfg, mk_tris, subdiv = CASES[case]
    tex, tris = mk_tex(), mk_tris()
    M = 4 ** subdiv
    items = [(t, None) for t in tris]
    if partial:
        items = []
        for k, t in enumerate(tris):
            st = np.full(M, 3, np.uint8)
            st[k % 3::3] = 0
            items.append((t, st))
    pre = batch.precompute(tex, tris, subdiv,
                           host._group_level(tex, tris, subdiv))
    return batch._Batch(tex, cfg, items, subdiv, list(range(len(items))),
                        [None] * len(items), not partial, pre, cuda, None)


@pytest.mark.parametrize("partial", [False, True],
                         ids=["fresh", "partial"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_kernels_match_plain(case, partial, cuda):
    """Every call of the descent and tile-slot kernels in a batch's
    discovery path, its capacity chain at the recorded caps and at an
    eighth of them (every count past its capacity): each kernel's result
    equals its plain version's on the same inputs, on every lane; every
    launch counts; the overflow sets the payload's flag."""
    job = _chain_job(case, cuda, partial)
    calls = []
    ot.reset_launches()
    with chain.recording(calls):
        batch._run_batch(job)
        entry = job.texture._omm_torch_caps[job.cap_key]
        inputs = [t.to(cuda) for t in job.host_inputs()]
        batch.spec_fn(job, entry)(*inputs)
        small = (tuple(max(c // 8, 1) for c in entry[0]),
                 max(entry[1] // 8, 1), tuple(max(n // 8, 1)
                                              for n in entry[2]))
        pay = batch.spec_fn(job, small)(*inputs)
    torch.cuda.synchronize()
    counts = ot.launches()
    names = set()
    for kernel, name, fn, plain, args, kw, out in calls:
        assert chain.result_diff(out, plain(*args, **kw)) == 0, name
        names.add(name)
    assert names == {"descend_sides", "tile_keys", "tile_slots",
                     "slot_stream"}
    for k in ("descend_sides", "tile_keys", "tile_slots"):
        assert counts[k] == sum(c[0] == k for c in calls) > 0
    m = len(job.bp["levels"]) - 1
    nm = len(job.bp["mips"])
    assert int(pay[:4 * (m + 2 + nm)].view(torch.int32)[m + 1]) == 1


def test_graph_replay_counts_chain_launches(cuda):
    """A replayed batch graph counts the chain kernels it captured: one
    descend_sides launch per descent level, one tile_keys and one
    tile_slots launch per batch."""
    _SPEC_TEX.pop("clamp", None)
    batch._run_batch(_spec_job("clamp", cuda))
    batch._enqueue_spec(_spec_job("clamp", cuda))[2].synchronize()
    ot.reset_launches()
    job = _spec_job("clamp", cuda)
    batch._enqueue_spec(job)[2].synchronize()
    counts = ot.launches()
    assert ot.pipeline_counts()["graph_replay"] == 1
    assert counts["descend_sides"] == len(job.bp["levels"])
    assert counts["tile_keys"] == counts["tile_slots"] == 1
    assert counts["exact_classify"] == job.texture.mip_count


def test_chain_wrappers_reject_mixed_devices(cuda):
    """Each chain wrapper raises on tensors split between the CPU and the
    card and on a bad dtype on the card, and launches nothing."""
    uv = torch.zeros((2, 6), device=cuda)
    cls = [torch.zeros((8, 8), dtype=torch.int8)]
    kw = dict(E=4, level=1, n_out=8, mips=[(8, 8)], pads=[1],
              periods=[None])
    ot.reset_launches()
    with pytest.raises(ValueError):
        chain.descend_sides(None, None, uv_flat=uv, cls=cls, **kw)
    with pytest.raises(ValueError):
        chain.descend_sides(None, None, uv_flat=uv.double(),
                            cls=[c.to(cuda) for c in cls], **kw)
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        chain.tile_keys(ids, None, subdiv=2, uv_flat=uv, mips=[(8, 8)],
                        pads=[1], ntxs=[1], periods=[None])
    st = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        chain.tile_slots(st, torch.zeros((1, 4), dtype=torch.int64), ids,
                         [1])
    with pytest.raises(ValueError):
        chain.slot_stream(ids.to(cuda), ids.to(cuda), ids.to(cuda), 1)
    assert all(ot.launches()[k] == 0
               for k in ("descend_sides", "tile_keys", "tile_slots"))


def test_chain_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel's C entry refuses (more mips than it takes)
    raises RuntimeError; the plain version does not stand in."""
    monkeypatch.setattr(chain, "MAX_MIPS", 17)
    mips = [(8, 8)] * 17
    uv = torch.zeros((1, 6), device=cuda)
    cls = [torch.zeros((8, 8), dtype=torch.int8, device=cuda)] * 17
    with pytest.raises(RuntimeError, match="descend_sides launch failed"):
        chain.descend_sides(None, None, E=4, level=1, n_out=4, uv_flat=uv,
                            cls=cls, mips=mips, pads=[1] * 17,
                            periods=[None] * 17)


def test_chain_build_error_raises(cuda, monkeypatch):
    """A chain library that does not build raises from the wrapper; the
    plain version does not stand in."""
    monkeypatch.delitem(build._LIBS, "omm_chain_cuda", raising=False)
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ["--no-such-nvcc-flag"])
    ids = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="failed"):
        chain.tile_keys(ids, None, subdiv=2,
                        uv_flat=torch.zeros((1, 6), device=cuda),
                        mips=[(8, 8)], pads=[1], ntxs=[1], periods=[None])
