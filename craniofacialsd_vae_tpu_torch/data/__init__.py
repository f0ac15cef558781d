from .dataset import (BatchIterator, DatasetSummary, DeviceBatchIterator,
                      MeshArrays, build_datasets, compute_class_weights,
                      find_filenames, split_files)
from .swap import choose_region, swap_features, swap_features_dynamic

__all__ = ["BatchIterator", "DatasetSummary", "DeviceBatchIterator",
           "MeshArrays", "build_datasets", "compute_class_weights",
           "find_filenames", "split_files", "choose_region", "swap_features",
           "swap_features_dynamic"]
