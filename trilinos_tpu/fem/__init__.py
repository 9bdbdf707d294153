"""FE discretization layer (the Intrepid2 + Shards + pamgen-lite analogue).

Reference: packages/intrepid2/src — Discretization/Basis (HGRAD Lagrange
bases per cell topology, Intrepid2_HGRAD_*_FEM.hpp), Discretization/
Integration (cubature factories), Cell/Intrepid2_CellTools.hpp (Jacobians,
ref↔phys maps, HGRAD transforms); packages/shards/src/Shards_CellTopology
.hpp (topology descriptions); packages/pamgen (inline structured mesh
generation). Assembly feeds the existing ``ops.fe`` Export-sum.

Accelerator-first structure: bases are closed-form numpy tables evaluated ONCE at
the cubature points of a reference cell; per-element work (Jacobians,
transforms, local stiffness) is one batched einsum over all elements —
there is no per-element loop anywhere, so the whole assembly pipeline is
a handful of (ne, q, n, d)-shaped contractions that run on host numpy for
setup or on device for matrix-free residuals.
"""

from .cells import CellTopology, HEX8, LINE2, QUAD4, TET4, TRI3
from .basis import hgrad_basis, lagrange_nodes_1d
from .cubature import cubature
from .cell_tools import (hgrad_transform_grad, jacobian, jacobian_det,
                         jacobian_inv, map_to_physical)
from .mesh import Mesh, structured_hex_mesh, structured_quad_mesh, \
    structured_tet_mesh, structured_tri_mesh
from .assembly import load_vector, mass_matrix, poisson_dirichlet, \
    stiffness_matrix
from .phalanx import Evaluator, FieldManager, PhysicsBlock
from .mortar import (interface_dofs, mortar_glue, mortar_projection_1d,
                     mortar_saddle)
from .refine import refine_uniform

__all__ = [
    "CellTopology", "LINE2", "TRI3", "QUAD4", "TET4", "HEX8",
    "hgrad_basis", "lagrange_nodes_1d", "cubature", "jacobian",
    "jacobian_det", "jacobian_inv", "map_to_physical",
    "hgrad_transform_grad", "Mesh", "structured_quad_mesh",
    "structured_tri_mesh", "structured_hex_mesh", "structured_tet_mesh",
    "stiffness_matrix", "mass_matrix", "load_vector", "poisson_dirichlet",
    "Evaluator", "FieldManager", "PhysicsBlock",
    "mortar_projection_1d", "mortar_glue", "mortar_saddle",
    "interface_dofs", "refine_uniform",
]
