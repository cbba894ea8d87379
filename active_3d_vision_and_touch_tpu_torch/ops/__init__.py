from active_3d_vision_and_touch_tpu_torch.ops.chamfer import (  # noqa: F401
    NN_EXACT,
    chamfer_distance,
    chamfer_distance_sharded,
    chamfer_shard_terms,
    mesh_chamfer_distance,
    min_dists,
)
from active_3d_vision_and_touch_tpu_torch.ops.chamfer_cluster import (  # noqa: F401
    NN_CLUSTER,
    SELECT_CHUNKS,
    chamfer_clustered_tiled_gt,
    chamfer_distance_clustered,
    min_dists_clustered,
    nn_cluster,
    select_chunks,
)
from active_3d_vision_and_touch_tpu_torch.ops.encoding import nerf_embedding  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.ops.grid_sample import (  # noqa: F401
    bilinear_sample,
)
from active_3d_vision_and_touch_tpu_torch.ops.sample import (  # noqa: F401
    batch_sample,
    draw_sample_noise,
)
from active_3d_vision_and_touch_tpu_torch.ops.segsum import (  # noqa: F401
    SEGSUM,
    scatter_add_3,
    segment_accumulate_sorted,
)

# every hand-written kernel of the package, in the order they were written
KERNELS = (NN_EXACT, SEGSUM, NN_CLUSTER, SELECT_CHUNKS)
