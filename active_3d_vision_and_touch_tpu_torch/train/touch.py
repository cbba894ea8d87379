"""Touch-chart trainer.

Port of the JAX package's ``train/touch.py``.  Batches: ``sim_touch``
(B, 121, 121, 3) in [0, 1], ``ref_pos`` (B, 3), ``ref_rot`` (B, 3, 3),
``samples`` (B, num_samples, 3) local ground-truth touch point clouds.
Loss: loss_coeff * mean over the batch of the 3-repeat Chamfer distance
between the predicted chart mesh, sampled at ``num_samples`` points, and
``samples``.

Spans (``utils/profiler.py``, recorded under a profiler): ``touch.encode``,
the encoder's forward with the rigid transform, in ``_loss`` (so under
``recon.forward_loss`` or ``recon.eval_step``) and in ``predict``;
``touch.chamfer``, the chart sampler and the 3-repeat Chamfer, under
``recon.forward_loss`` (or ``recon.eval_step``); neither runs in a step
replayed from its CUDA graph (``train/base.py``).  Counter ``touch.charts``:
the rows predicted, on every forward (training, evaluation, ``predict``,
and each replay, which adds its capture's count).
"""

from __future__ import annotations

import torch

from active_3d_vision_and_touch_tpu_torch.core import touch_chart
from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig
from active_3d_vision_and_touch_tpu_torch.core.device import resolve_device
from active_3d_vision_and_touch_tpu_torch.models.touch import TouchChartEncoder
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import mesh_chamfer_distance
from active_3d_vision_and_touch_tpu_torch.train.base import ReconEngine
from active_3d_vision_and_touch_tpu_torch.utils.profiler import count, span


class TouchEngine(ReconEngine):
    loss_tag = "touch_cd"

    def __init__(self, config: TouchConfig | None = None, device="cuda", log: bool = True):
        config = config or TouchConfig()
        device = resolve_device(device)
        chart = touch_chart()
        self.chart_verts = torch.as_tensor(chart.verts, device=device)
        self.chart_faces = torch.as_tensor(chart.faces, device=device).long()
        # weights drawn on the CPU from the config's seed: every device
        # starts from the same ones
        model = init_modules_(TouchChartEncoder(), torch.Generator().manual_seed(config.seed))
        self.model = model.to(device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.lr)
        super().__init__(config, device=device, log=log)

    def sample_points(self) -> int:
        return self.config.num_samples

    def _encode(self, sim_touch, ref_pos, ref_rot) -> torch.Tensor:
        """(B, 25, 3) charts in the fingertip frames."""
        count("touch.charts", sim_touch.shape[0])
        with span("touch.encode"):
            return self.model(sim_touch, ref_pos, ref_rot, self.chart_verts)

    def _loss(self, batch: dict, generator, draws) -> torch.Tensor:
        verts = self._encode(batch["sim_touch"], batch["ref_pos"], batch["ref_rot"])
        with span("touch.chamfer"):
            cd = mesh_chamfer_distance(
                verts,
                self.chart_faces,
                batch["samples"],
                generator,
                num=self.config.num_samples,
                nn=self.config.loss_nn,
                draws=draws,
                shard=self.shard,
            )
        return self.config.loss_coeff * cd.mean()

    def predict(self, sim_touch, ref_pos, ref_rot) -> torch.Tensor:
        """Frozen inference, as the active environment uses it."""
        self.model.eval()
        with torch.no_grad():
            return self._encode(sim_touch, ref_pos, ref_rot)
