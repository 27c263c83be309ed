"""The GPU baker: `omm_tpu_torch.gpu.Pipeline().dispatch(cfg).execute()`,
its dispatch chain run on the card, default engine and flags."""
from __future__ import annotations

from ommbench.entries.cpu_bake import prepare, texture  # noqa: F401  (the same)

BAKER = "gpu"


def describe(state, texture, uvs, indices):
    ot, d = state["ot"], state["desc"]
    gpu = ot.gpu
    cfg = gpu.DispatchConfigDesc(
        alpha_texture=texture, alpha_texture_channel=0,
        tex_coords=uvs, index_buffer=indices, index_count=len(indices),
        alpha_cutoff=d["alpha_cutoff"],
        max_subdivision_level=d["max_subdivision_level"],
        dynamic_subdivision_scale=d["dynamic_subdivision_scale"],
        global_format=ot.Format(d["format"]),
        bake_flags=gpu.GpuBakeFlags(d["bake_flags"]),
        unknown_state_promotion=ot.UnknownStatePromotion(
            d["unknown_state_promotion"]),
        alpha_cutoff_greater=ot.OpacityState(d["alpha_cutoff_greater"]),
        alpha_cutoff_less_equal=ot.OpacityState(
            d["alpha_cutoff_less_equal"]))
    cfg.runtime_sampler.addressing_mode = ot.TextureAddressMode(
        d["addressing_mode"])
    cfg.runtime_sampler.filter = ot.TextureFilterMode(d["filter"])
    return cfg


def call(state, inp):
    # a pipeline per dispatch, as the API's callers build it: a kept
    # Pipeline stores every dispatch's setup
    return state["ot"].gpu.Pipeline().dispatch(
        inp, state["device"]).execute()[0]
