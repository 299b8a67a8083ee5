"""The problems of the benchmark, one file each, found by the name in a
configuration's `problem`: the Dirichlet data, the seeded start state and
the plain reference of one time step (benchmark/reference), all worked
out from the configuration and the benchmark's mesh."""
