"""The program's entry points that a configuration can name: one module
each, found by the configuration's "entry".  Each gives BAKER (which of
the reference's bakers it is held to), `prepare(ot, config, device)`
(what every bake reads), `texture(state, texture)` (the program's
texture object of a generator's texture), `describe(state, texture,
uvs, indices)` (one bake's input) and `call(state, inp)` (the
BakeResult, on the host)."""
