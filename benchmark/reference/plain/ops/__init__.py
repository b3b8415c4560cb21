"""Key arithmetic, sparse sets, family convs and top-k (kernels K1-K3)."""

from . import coords, family
from .sparse import (SparseTensor, from_points, from_points_host,
                     voxelize_host_np, compact, lookup, features_at,
                     downsample_keys, upsample_children_keys,
                     expand_region_keys, with_feats, concat)
from .conv import (apply_sparse_conv, apply_channelwise_conv, apply_avg_pool,
                   init_conv_weights, gather_neighbors)
from .topk import topk_mask, prune
