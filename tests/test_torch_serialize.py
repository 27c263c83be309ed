"""omm_tpu_torch.serialize against omm_tpu.serialize.

The reference SDK's golden blobs in tests/data/ deserialize in the port
to what the JAX package reads from them (input descriptors field by
field, results as numpy arrays), and the port bakes the golden inputs
to the suite's statistics.  Input descriptors built in both packages
from the same numpy arrays, and the results the two packages bake from
them, serialize to the same bytes, compressed and not; each package
reads the other's blobs and writes them back unchanged."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import serialize as jser  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402
from omm_tpu_torch import serialize as tser  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402

from fixtures import standard_circle  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_STATS = dict(total_opaque=152, total_transparent=232,
                    total_unknown_transparent=70, total_unknown_opaque=58)
INPUTS = ["input_v1_4_0", "input_v1_5_0", "input_compress_v1_5_0"]
OUTPUTS = ["output_v1_4_0", "output_compress_v1_4_0", "output_v1_5_0",
           "output_compress_v1_5_0", "output_compress_v1_6_0",
           "output_compress_v1_7_0"]


def _load(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _input_fields(desc) -> dict:
    """An input descriptor of either package as numpy arrays, ints and
    floats, texture and sampler included."""
    out = {}
    for f in dataclasses.fields(desc):
        v = getattr(desc, f.name)
        if f.name == "texture":
            out["texture"] = (int(v.format), int(v.flags), v.alpha_cutoff,
                              [m.tobytes() for m in v.mips], v.has_sat())
        elif f.name == "runtime_sampler":
            out[f.name] = (int(v.addressing_mode), int(v.filter),
                           v.border_alpha)
        elif isinstance(v, np.ndarray):
            out[f.name] = (v.dtype.str, v.shape, v.tobytes())
        else:
            out[f.name] = v if v is None or isinstance(v, float) else int(v)
    return out


def _assert_results_equal(a, b):
    """Every serialized field equal (a blob carries no triangle areas)."""
    a, b = convert.result_to_numpy(a), convert.result_to_numpy(b)
    for k in a:
        if k != "triangle_area":
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", INPUTS)
def test_golden_input_reads_like_jax_and_bakes(name):
    blob = _load(name)
    got, want = tser.deserialize(blob), jser.deserialize(blob)
    assert got.flags == want.flags and not got.result_descs
    assert len(got.input_descs) == len(want.input_descs) == 1
    assert _input_fields(got.input_descs[0]) \
        == _input_fields(want.input_descs[0])
    st = ot.get_stats(ot.bake(got.input_descs[0], device="cpu"))
    assert {k: getattr(st, k) for k in GOLDEN_STATS} == GOLDEN_STATS
    for flags in (0, 1):
        assert tser.serialize(tser.DeserializedDesc(
            flags=flags, input_descs=got.input_descs)) \
            == jser.serialize(jser.DeserializedDesc(
                flags=flags, input_descs=want.input_descs))


@pytest.mark.parametrize("name", OUTPUTS)
def test_golden_output_reads_like_jax(name):
    blob = _load(name)
    got, want = tser.deserialize(blob), jser.deserialize(blob)
    assert got.flags == want.flags and not got.input_descs
    assert len(got.result_descs) == len(want.result_descs) == 1
    _assert_results_equal(got.result_descs[0], want.result_descs[0])
    st = ot.collect_stats(got.result_descs[0])
    assert {k: getattr(st, k) for k in GOLDEN_STATS} == GOLDEN_STATS


def test_corrupted_blob_rejected():
    with pytest.raises(ttypes.BakeError) as ei:
        tser.deserialize(_load("input_v1_5_0")[:-4])
    assert ei.value.result == ttypes.Result.INVALID_ARGUMENT
    with pytest.raises(ttypes.BakeError):
        tser.deserialize(b"")


def _circle(n):
    return standard_circle(n, n)


def _case_golden():
    """The GenerateSerializedString workload (test_serialize._bake_desc)."""
    return dict(planes=[_circle(8)], texture_format=1, addressing_mode=2,
                filter=1, bake_flags=1, alpha_mode=0,
                tex_coords=np.array([[0, 0], [0, 1], [1, 0], [1, 1]],
                                    np.float32),
                index_buffer=np.array([0, 1, 2, 3, 1, 2], np.uint32),
                index_count=6, alpha_cutoff=0.5,
                dynamic_subdivision_scale=0.0, unknown_state_promotion=0,
                max_subdivision_level=4)


def _case_unorm8_sat():
    """UNORM8 texture in linear tiling with its cutoff embedded (a SAT
    blob), Border sampling, 16-bit indices, 2-state format."""
    plane = (_circle(16) * 255).astype(np.uint8)
    return dict(planes=[plane], texture_format=0, texture_flags=1,
                texture_alpha_cutoff=0.5, addressing_mode=3, filter=1,
                border_alpha=0.25, index_format=1,
                tex_coords=np.array([[0.1, 0.1], [0.1, 0.9], [0.9, 0.2]],
                                    np.float32),
                index_buffer=np.array([0, 1, 2], np.uint16), index_count=3,
                format=1, alpha_cutoff_greater=1, alpha_cutoff_less_equal=0,
                max_subdivision_level=5, dynamic_subdivision_scale=0.0)


def _case_per_triangle():
    """Two mips, per-triangle formats (INVALID takes the global one) and
    subdivision levels, a rejection threshold, a workload limit and the
    nearest filter."""
    rng = np.random.RandomState(4)
    return dict(planes=[_circle(32), _circle(16)], texture_format=1,
                addressing_mode=0, filter=0,
                tex_coords=rng.rand(6, 2).astype(np.float32),
                index_buffer=np.array([0, 1, 2, 3, 4, 5, 1, 2, 3],
                                      np.uint32),
                index_count=9, formats=np.array([0, 2, 0], np.int32),
                subdivision_levels=np.array([2, 13, 4], np.uint8),
                rejection_threshold=0.25, max_workload_size=1 << 40,
                max_array_data_size=4096, max_subdivision_level=6,
                unresolved_tri_state=-2)


def _case_strided():
    """Stride-16 interleaved UVs: the reference's quirk payload."""
    inter = np.zeros((4, 4), np.float32)
    inter[:, 0:2] = [[0, 0], [0, 1], [1, 0], [1, 1]]
    return dict(planes=[_circle(8)], texture_format=1,
                tex_coords=inter.reshape(-1).view(np.uint8),
                tex_coord_stride_in_bytes=16,
                index_buffer=np.array([0, 1, 2, 3, 1, 2], np.uint32),
                index_count=6, dynamic_subdivision_scale=0.0,
                max_subdivision_level=4)


CASES = {"golden": _case_golden, "unorm8_sat": _case_unorm8_sat,
         "per_triangle": _case_per_triangle, "strided": _case_strided}

def _jax_desc(case: dict):
    """The JAX package's descriptor of a case's arrays and ints."""
    c = dict(case)
    planes = c.pop("planes")
    tex = omm.Texture(planes, omm.TextureFormat(c.pop("texture_format")),
                      omm.TextureFlags(c.pop("texture_flags", 0)),
                      c.pop("texture_alpha_cutoff", -1.0))
    sampler = omm.SamplerDesc()
    if "addressing_mode" in c:
        sampler.addressing_mode = omm.TextureAddressMode(
            c.pop("addressing_mode"))
    if "filter" in c:
        sampler.filter = omm.TextureFilterMode(c.pop("filter"))
    sampler.border_alpha = c.pop("border_alpha", 0.0)
    enums = {"bake_flags": omm.BakeFlags, "alpha_mode": omm.AlphaMode,
             "index_format": omm.IndexFormat, "format": omm.Format,
             "alpha_cutoff_greater": omm.OpacityState,
             "alpha_cutoff_less_equal": omm.OpacityState,
             "unknown_state_promotion": omm.UnknownStatePromotion,
             "unresolved_tri_state": omm.SpecialIndex}
    c = {k: enums[k](v) if k in enums else v for k, v in c.items()}
    return omm.BakeInputDesc(texture=tex, runtime_sampler=sampler, **c)


def _port_desc(case: dict):
    c = dict(case)
    return convert.bake_input(c.pop("planes"), c.pop("texture_format"), **c)


@pytest.mark.parametrize("compress", [0, 1], ids=["plain", "lz4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_input_blobs_byte_equal(case, compress):
    """The port's input blob equals the JAX package's; each package reads
    the other's blob to the same descriptor and writes it back
    unchanged."""
    fields = CASES[case]()
    tblob = tser.serialize(tser.DeserializedDesc(
        flags=compress, input_descs=[_port_desc(fields)]))
    jblob = jser.serialize(jser.DeserializedDesc(
        flags=compress, input_descs=[_jax_desc(fields)]))
    assert tblob == jblob
    t_back, j_back = tser.deserialize(jblob), jser.deserialize(tblob)
    assert _input_fields(t_back.input_descs[0]) \
        == _input_fields(j_back.input_descs[0])
    assert tser.serialize(t_back) == jblob
    assert jser.serialize(j_back) == tblob


@pytest.mark.parametrize("compress", [0, 1], ids=["plain", "lz4"])
@pytest.mark.parametrize("case", ["golden", "unorm8_sat", "per_triangle"])
def test_result_blobs_byte_equal(case, compress):
    """The result the port bakes and the numpy backend's serialize to the
    same bytes, alone and beside their input; each package reads the
    other's blob.  The golden workload's payload equals the reference
    SDK's output_v1_5_0 past the header."""
    fields = CASES[case]()
    tdesc, jdesc = _port_desc(fields), _jax_desc(fields)
    tres = ot.bake(tdesc, device="cpu")
    jres = omm.bake(jdesc, backend="numpy")
    tblob = tser.serialize(tser.DeserializedDesc(
        flags=compress, input_descs=[tdesc], result_descs=[tres]))
    jblob = jser.serialize(jser.DeserializedDesc(
        flags=compress, input_descs=[jdesc], result_descs=[jres]))
    assert tblob == jblob
    _assert_results_equal(tser.deserialize(jblob).result_descs[0], jres)
    _assert_results_equal(jser.deserialize(tblob).result_descs[0], tres)
    if case == "golden" and not compress:
        alone = tser.serialize(tser.DeserializedDesc(result_descs=[tres]))
        assert alone[32:] == _load("output_v1_5_0")[32:]
