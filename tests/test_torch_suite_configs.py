"""The suite-config matrix (tests/test_suite_configs.py) through the port
on the CPU: the reference re-instantiates its bake suite under
{Default, DisableZOrder, Force32BitIndices, UNORM8, AlphaCutoff,
Serialize} and expects the same stats under each
(test_omm_bake_cpu.cpp:2581-2589).  AlphaCutoff embeds the cutoff in
the texture, which turns on the coarse SAT pass; Serialize bakes the
input after a serialize/deserialize round trip and round-trips the
result.  Each config's stats are the reference's, and its result is
byte-equal to the JAX package's numpy backend."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402

from fixtures import (DEFAULT_INDICES, DEFAULT_TEXCOORDS,  # noqa: E402
                      expect_stats, sine_fp32, standard_circle)

CIRCLE_STATS = dict(total_opaque=204, total_transparent=219,
                    total_unknown_transparent=39, total_unknown_opaque=50)
SINE_STATS = dict(total_opaque=224, total_transparent=128,
                  total_unknown_transparent=96, total_unknown_opaque=64)
PLANES = {"circle": (lambda: standard_circle(1024, 1024), CIRCLE_STATS),
          "sine": (lambda: sine_fp32(1024, 1024), SINE_STATS)}
CONFIGS = ["default", "disable_zorder", "force32", "unorm8", "alpha_cutoff",
           "serialize"]
# the sine plane scaled to UNORM8 is another texture (the reference's
# SineUNORM8 has stats of its own), so it runs the other five configs
CASES = [(t, c) for t in sorted(PLANES) for c in CONFIGS
         if (t, c) != ("sine", "unorm8")]


def _inputs(plane, cfg):
    """(planes, texture format, texture flags, texture cutoff, bake
    flags) of one config, as ints."""
    tex_fmt, tex_flags, tex_cutoff = int(omm.TextureFormat.FP32), 0, -1.0
    flags = int(omm.BakeFlags.EnableInternalThreads)
    if cfg == "unorm8":
        plane = (plane * np.float32(255.0)).astype(np.uint8)
        tex_fmt = int(omm.TextureFormat.UNORM8)
    elif cfg == "disable_zorder":
        tex_flags = int(omm.TextureFlags.DisableZOrder)
    elif cfg == "force32":
        flags |= int(omm.BakeFlags.Force32BitIndices)
    elif cfg == "alpha_cutoff":
        tex_cutoff = 0.5
    return [plane], tex_fmt, tex_flags, tex_cutoff, flags


def _fields(flags):
    return dict(tex_coords=DEFAULT_TEXCOORDS, index_buffer=DEFAULT_INDICES,
                index_count=len(DEFAULT_INDICES),
                index_format=int(omm.IndexFormat.UINT_32), alpha_cutoff=0.5,
                format=int(omm.Format.OC1_4_State),
                unknown_state_promotion=int(
                    omm.UnknownStatePromotion.Nearest),
                max_subdivision_level=4, dynamic_subdivision_scale=0.0,
                bake_flags=flags)


@pytest.mark.parametrize("texture,cfg", CASES)
def test_config_stats(texture, cfg):
    make, want = PLANES[texture]
    planes, tex_fmt, tex_flags, tex_cutoff, flags = _inputs(make(), cfg)
    desc = convert.bake_input(planes, tex_fmt, texture_flags=tex_flags,
                              texture_alpha_cutoff=tex_cutoff,
                              addressing_mode=int(
                                  omm.TextureAddressMode.Clamp),
                              filter=int(omm.TextureFilterMode.Linear),
                              **_fields(flags))
    if cfg == "serialize":
        blob = ot.serialize.serialize(
            ot.serialize.DeserializedDesc(input_descs=[desc]))
        desc = ot.serialize.deserialize(blob).input_descs[0]
    res = ot.bake(desc, device="cpu")
    expect_stats(ot.get_stats(res), **want)
    if cfg == "serialize":
        blob = ot.serialize.serialize(ot.serialize.DeserializedDesc(
            result_descs=[res], flags=ot.serialize.SerializeFlags.COMPRESS))
        back = ot.serialize.deserialize(blob).result_descs[0]
        assert np.array_equal(back.array_data, res.array_data)
        assert back.desc_array == res.desc_array
    jf = _fields(omm.BakeFlags(flags))
    for k, e in (("index_format", omm.IndexFormat), ("format", omm.Format),
                 ("unknown_state_promotion", omm.UnknownStatePromotion)):
        jf[k] = e(jf[k])
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat(tex_fmt),
                            omm.TextureFlags(tex_flags),
                            alpha_cutoff=tex_cutoff),
        runtime_sampler=omm.SamplerDesc(
            addressing_mode=omm.TextureAddressMode.Clamp,
            filter=omm.TextureFilterMode.Linear), **jf)
    want_np = convert.result_to_numpy(omm.bake(jdesc, backend="numpy"))
    got_np = convert.result_to_numpy(res)
    for k in want_np:
        assert np.array_equal(got_np[k], want_np[k]), k
