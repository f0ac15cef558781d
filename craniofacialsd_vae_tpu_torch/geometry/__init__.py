from .bundle import GeometryBundle, SparseCOO, load_bundle
from .halfedge import HalfedgeMesh
from .mesh_io import (MeshData, read_mesh, read_obj, read_ply, write_obj,
                      write_ply)
from .precompute import (import_reference_spirals,
                         import_reference_transforms,
                         load_or_compute_geometry, precompute_geometry,
                         save_bundle)
from .simplify import (simplification_hierarchy, simplify_mesh,
                       upsampling_transform)
from .spirals import extract_spirals
from .synthetic import (adversarial_mesh, level0_positions, octasphere,
                        standin_laplacian_coo, standin_region_masks,
                        synthetic_template, uv_sphere)
from .template import (COLOUR2ATTRIBUTE, PROCEDURES2ATTRIBUTES, Template,
                       load_template, rw_laplacian_coo, template_from_mesh,
                       unique_edges)

__all__ = ["GeometryBundle", "SparseCOO", "load_bundle", "HalfedgeMesh",
           "MeshData", "read_mesh", "read_obj", "read_ply", "write_obj",
           "write_ply", "import_reference_spirals",
           "import_reference_transforms", "load_or_compute_geometry",
           "precompute_geometry", "save_bundle", "simplification_hierarchy",
           "simplify_mesh", "upsampling_transform", "extract_spirals",
           "adversarial_mesh", "level0_positions",
           "octasphere", "standin_laplacian_coo", "standin_region_masks",
           "synthetic_template", "uv_sphere", "COLOUR2ATTRIBUTE",
           "PROCEDURES2ATTRIBUTES", "Template", "load_template",
           "rw_laplacian_coo", "template_from_mesh", "unique_edges"]
