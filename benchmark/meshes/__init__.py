"""Mesh generators of the benchmark, one file each, found by the name
in a configuration's `mesh.generator`; each has make(config, cache_dir)."""
