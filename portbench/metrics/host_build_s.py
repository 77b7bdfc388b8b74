"""Seconds of the program's host build: meshes, assembly, multigrid and
the sweep's tables (FEM), or the mesh and its statics (BEM), timed
around the constructors."""


def read(rec):
    return rec["host_build_s"]
