from active_3d_vision_and_touch_tpu_torch.data.datasets import (  # noqa: F401
    ActiveDataset,
    Loader,
    TouchDataset,
    VisionDataset,
    load_split,
    object_dirs,
)
from active_3d_vision_and_touch_tpu_torch.data.primitives import random_object  # noqa: F401
