from active_3d_vision_and_touch_tpu_torch.core.actions import action_sphere  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.core.adjacency import (  # noqa: F401
    AdjInfo,
    build_adj_info,
    calc_adj,
    fuse_touch,
    normalize_adj,
)
from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.core.config import SimConfig  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.core.mesh import (  # noqa: F401
    TOUCH_CHART_CENTER,
    Mesh,
    add_reverse_faces,
    load_obj,
    save_obj,
    scale_points,
    touch_chart,
    vision_charts,
)
