from .distances import (chamfer_distance, nearest_dists_sq,
                        nearest_dists_sq_sym)
from .pool import build_pool_operator, pool, selection_indices
from .sparse import (CappedEll, GatherRows, PaddedRowSparse, capped_ell,
                     ell_matmul, ell_matmul_capped_plain, ell_matmul_plain,
                     ell_matmul_raw, ell_tier_add_plain, from_coo,
                     gather_op_from_idx, gather_rows, tier_links)
from .spiral_conv import (OutGatherBwd, SpiralOp, SpiralTiles,
                          build_out_gather_bwd, build_spiral_op,
                          build_spiral_tiles, init_spiral_conv,
                          out_gather_sum_bwd_plain, out_gather_sum_plain,
                          spiral_conv, spiral_conv_dw,
                          spiral_conv_dw_chunked_plain, spiral_conv_dw_plain,
                          spiral_conv_out_gather, spiral_conv_plain)

__all__ = ["build_pool_operator", "pool", "selection_indices", "CappedEll",
           "GatherRows", "PaddedRowSparse", "capped_ell", "ell_matmul",
           "ell_matmul_capped_plain", "ell_matmul_plain", "ell_matmul_raw",
           "ell_tier_add_plain", "from_coo", "gather_op_from_idx",
           "gather_rows", "tier_links", "OutGatherBwd", "SpiralOp",
           "SpiralTiles", "build_out_gather_bwd", "build_spiral_op",
           "build_spiral_tiles", "init_spiral_conv", "spiral_conv",
           "spiral_conv_dw", "spiral_conv_dw_chunked_plain",
           "spiral_conv_dw_plain", "spiral_conv_plain",
           "spiral_conv_out_gather",
           "out_gather_sum_plain", "out_gather_sum_bwd_plain",
           "chamfer_distance", "nearest_dists_sq", "nearest_dists_sq_sym"]
