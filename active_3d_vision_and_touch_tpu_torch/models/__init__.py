from active_3d_vision_and_touch_tpu_torch.models.autoencoder import (  # noqa: F401
    FoldingDecoder,
    GCNEncoder,
    MeshAutoEncoder,
    folding_grid,
)
from active_3d_vision_and_touch_tpu_torch.models.gcn import (  # noqa: F401
    GCN,
    GCNLayer,
    MaskEncoder,
    PositionalEncoder,
)
from active_3d_vision_and_touch_tpu_torch.models.policy_nets import (  # noqa: F401
    ActionMaskEmbed,
    GraphValueNet,
    LatentValueNet,
)
from active_3d_vision_and_touch_tpu_torch.models.touch import (  # noqa: F401
    DoubleConv,
    TouchChartEncoder,
)
from active_3d_vision_and_touch_tpu_torch.models.vision import (  # noqa: F401
    Deformation,
    chart_plane_features,
    ImageEncoder,
    encoder_plan,
    init_modules_,
    pool_image_features,
    prepare_charts,
)
