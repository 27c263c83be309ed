"""The CPU-baker API: `omm_tpu_torch.bake(desc)`, ommCpuBake with the
classification on the card."""
from __future__ import annotations

BAKER = "cpu"


def prepare(ot, config, device):
    """What each bake reads."""
    return {"ot": ot, "desc": config["descriptor"], "device": device}


def texture(state, tex):
    """The texture object of a generator's texture, its mips on the host
    as the SDK's users hand them in."""
    ot = state["ot"]
    return ot.Texture([m.detach().cpu().numpy() for m in tex["mips"]],
                      ot.TextureFormat[tex["format"]])


def describe(state, texture, uvs, indices):
    ot, d = state["ot"], state["desc"]
    desc = ot.BakeInputDesc(
        texture=texture, tex_coords=uvs, index_buffer=indices,
        index_count=len(indices), alpha_cutoff=d["alpha_cutoff"],
        max_subdivision_level=d["max_subdivision_level"],
        dynamic_subdivision_scale=d["dynamic_subdivision_scale"],
        format=ot.Format(d["format"]),
        bake_flags=ot.BakeFlags(d["bake_flags"]),
        unknown_state_promotion=ot.UnknownStatePromotion(
            d["unknown_state_promotion"]),
        alpha_cutoff_greater=ot.OpacityState(d["alpha_cutoff_greater"]),
        alpha_cutoff_less_equal=ot.OpacityState(
            d["alpha_cutoff_less_equal"]))
    desc.runtime_sampler.addressing_mode = ot.TextureAddressMode(
        d["addressing_mode"])
    desc.runtime_sampler.filter = ot.TextureFilterMode(d["filter"])
    return desc


def call(state, inp):
    return state["ot"].bake(inp, state["device"])
