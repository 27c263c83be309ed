"""The traffic generators: one module each, found by the "generator" of
a traffic file (`ommbench/traffic/<traffic>.json`), which hands it its
"params".

A generator module gives `make(seed, config, params, device)`, which
returns an object with:

  textures: a list of {"format": "FP32" | "UNORM8", "mips": [tensor, ...]}
    on `device`, mip 0 first, made from the seed in set-up; the program
    is handed each as a texture object, and the reference reads the
    same tensors.
  per_bake_texture: False where the texture objects are made once in
    set-up and shared by every bake (the SDK's users create a texture
    once); True where each bake makes its own, inside its latency.
  texture_of(stream, i): which of `textures` bake i of a stream uses.
  mesh(stream, i): (uvs (V, 2) fp32, indices (3T,) uint32) of bake i of
    a stream (`inputs.WARMUP` or `inputs.TIMED`), drawn from the seed,
    so that the same seed gives the same meshes.

The harness counts each bake's micro-triangles from these inputs and
hands the reference the same textures and meshes.
"""
