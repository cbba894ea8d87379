from active_3d_vision_and_touch_tpu_torch.parallel.mesh import (  # noqa: F401
    average_gradients,
    batch_sharding,
    data_parallel_mesh,
    global_mean,
    hybrid_mesh,
    maybe_init_distributed,
    rank_device,
    replicate,
    shard_batch,
)
