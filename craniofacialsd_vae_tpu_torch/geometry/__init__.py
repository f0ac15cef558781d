from .bundle import GeometryBundle, SparseCOO, load_bundle
from .synthetic import (adversarial_mesh, level0_positions,
                        standin_laplacian_coo, standin_region_masks,
                        uv_sphere)
from .template import rw_laplacian_coo, unique_edges

__all__ = ["GeometryBundle", "SparseCOO", "load_bundle", "adversarial_mesh",
           "level0_positions", "standin_laplacian_coo",
           "standin_region_masks", "uv_sphere", "rw_laplacian_coo",
           "unique_edges"]
