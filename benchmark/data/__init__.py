"""Generators of each configuration's data from the seed, one module a
generator, found by the name a configuration file gives (`data.generator`).
Each module has `make(params, seed, device)`, `program_model(data, device)`
and `reference_model(data, device)`."""
