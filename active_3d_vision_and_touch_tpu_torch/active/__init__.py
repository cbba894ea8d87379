from active_3d_vision_and_touch_tpu_torch.active.env import ActiveTouchEnv  # noqa: F401
