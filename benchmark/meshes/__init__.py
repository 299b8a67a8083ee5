"""Mesh generators of the benchmark, one file each, found by the name
in a configuration's `mesh.generator`; each has make(config, cache_dir).

make returns a dict of numpy arrays of P1 simplices in d = 2
(triangles) or d = 3 (tetrahedra) dimensions: points (n, d) in the
configuration's dtype, cells (nc, d + 1), facets (nf, d) the boundary
facets, ordered so that their natural normal points out of the domain,
facet_cells (nf,) the cell of each facet, facet_local_index (nf,) the
facet's local index in that cell (the program's numbering: facet i
opposite vertex i), facet_tags (nf,) the boundary markers. The points
come in the order the program keeps: benchmark.cell.build_scenario
refuses a mesh that the program renumbers."""
