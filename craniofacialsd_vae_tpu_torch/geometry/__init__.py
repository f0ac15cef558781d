from .bundle import GeometryBundle, SparseCOO, load_bundle
from .synthetic import adversarial_mesh, uv_sphere

__all__ = ["GeometryBundle", "SparseCOO", "load_bundle", "adversarial_mesh",
           "uv_sphere"]
