from active_3d_vision_and_touch_tpu_torch.sim.hand import Hand  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.sim.grasp import AgnosticGrasp  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.sim.scene import Scene  # noqa: F401
from active_3d_vision_and_touch_tpu_torch.sim.sampler import Sampler  # noqa: F401
