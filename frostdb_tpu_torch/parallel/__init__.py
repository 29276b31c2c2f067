"""Execution over a device mesh.

The reference runs one SPMD program per part across a mesh of devices:
per-device filter + partial aggregation, then cross-device combines
(``psum``/``pmin``/``pmax``) and, for large key spaces, an ``all_to_all``
pair exchange. This package has the one-device case: ``make_mesh`` builds
a one-device mesh record, and ``mesh_exec`` holds the executor whose local
instance is the engine's ``dense`` tier (group-bys past the compiled tier's
2048 codes). Multi-device meshes, row-sharded tables, the distributed
join and the shuffle operators are not ported yet.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
