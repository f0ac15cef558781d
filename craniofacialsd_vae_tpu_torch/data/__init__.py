from .swap import choose_region, swap_features, swap_features_dynamic

__all__ = ["choose_region", "swap_features", "swap_features_dynamic"]
