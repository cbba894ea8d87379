"""Plain reference of the active-touch env's greedy step, after the
published description (pterotactyl ``policies/environment.py``; Smith et
al., arXiv 2107.09584): the myopic oracle scores every action for each
object of the env batch and commits the best.

- An object's state is its touch charts: one slot per grasp taken and
  finger, (25, xyz | code).  A grasp's signal comes from the object's
  chart cache (actions, 4 fingers, 25, xyz | code): a touching finger
  (code 2) gives its chart, a finger without touch (code 1) its sensor's
  position on every vertex, a failed grasp (code 0) zeros.  Slots are laid
  out finger by finger, then grasp by grasp.
- A score is ``loss_coeff`` times the 3-repeat Chamfer distance between
  the deformation model's mesh (eval mode) and the object's cloud, by
  exact search (``reference.vision``).
- The candidates of a step are scored ``chunk`` actions at a time, each
  chunk's meshes taking the next draw of the sampler's random numbers,
  row by row (object-major); the committed state's observation takes the
  draw after them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.vision import Reference, cast, draw_noise


def signal(cache: np.ndarray, action: int, fingers: list[int]) -> np.ndarray:
    """(nf, 25, 4) slots of one grasp from an object's chart cache."""
    slot = cache[action][fingers]
    codes = slot[:, 0, 3]
    xyz = np.where(codes[:, None, None] == 2, slot[:, :, :3],
                   np.where(codes[:, None, None] == 1, slot[:, :1, :3], 0.0))
    return np.concatenate([xyz, np.broadcast_to(codes[:, None, None], (len(fingers), 25, 1))], axis=-1)


def committed_state(caches: list, taken: list, grasps: int, fingers: list[int]) -> np.ndarray:
    """(b, nf, grasps, 25, 4) charts of the actions ``taken`` (one array
    of b actions per grasp so far)."""
    out = np.zeros((len(caches), len(fingers), grasps, 25, 4), np.float32)
    for g, actions in enumerate(taken):
        for i, a in enumerate(actions):
            out[i, :, g] = signal(caches[i], int(a), fingers)
    return out


class GreedyReference:
    """The env's scores for the model of ``cfg`` with weights ``weights``,
    in ``dtype`` (the control computes in bfloat16)."""

    def __init__(self, cfg: dict, weights: dict, device, dtype=torch.float32):
        self.cfg, self.device = cfg, torch.device(device)
        self.ref = Reference(cfg, device, dtype=dtype)
        self.p = cast(weights, dtype, device)
        self.fingers = [1] if cfg["finger"] else [0, 1, 2, 3]

    def scores(self, img, gt, states: np.ndarray, gen: torch.Generator, meshes: bool = False):
        """(rows,) scores of chart states (rows, nf, grasps, 25, 4) of the
        objects' images (rows, H, W, 3) and clouds (rows, n, 3); with
        ``meshes`` also the meshes (rows, V, 3)."""
        rows, num = states.shape[0], self.cfg["number_points"]
        draws = draw_noise(gen, rows, num * self.cfg["repeat"], self.device)
        batch = {"img": img, "gt_points": gt,
                 "touch_charts": torch.as_tensor(states, device=self.device)}
        with torch.no_grad():
            rows, verts = self.ref.mesh_distances(self.p, batch, draws, train=False)
        score = self.cfg["loss_coeff"] * rows
        return (score, verts) if meshes else score

    def step(self, img, gt, caches: list, taken: list, chosen: np.ndarray, gen_state: torch.Tensor,
             fault: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One greedy step from the state of ``taken``: (b, A) scores of
        every action, then (b,) the observation's score once ``chosen`` is
        committed.  ``gen_state`` is the sampler's generator as the step
        found it.  ``fault`` "row0x2" doubles the first mesh's score."""
        b, grasps = len(caches), self.cfg["num_grasps"]
        actions, slot = self.cfg["num_actions"], len(taken)
        chunk = min(self.cfg["candidate_chunk"], actions)
        img, gt = (torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device) for x in (img, gt))
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        base = committed_state(caches, taken, grasps, self.fingers)
        out = []
        for start in range(0, actions, chunk):
            # a last short chunk is padded with its first action
            cols = [start + j if start + j < actions else start for j in range(chunk)]
            states = np.repeat(base[:, None], chunk, axis=1)
            for i in range(b):
                for j, a in enumerate(cols):
                    states[i, j, :, slot] = signal(caches[i], a, self.fingers)
            s = self.scores(img.repeat_interleave(chunk, 0), gt.repeat_interleave(chunk, 0),
                            states.reshape(b * chunk, *base.shape[1:]), gen)
            if fault == "row0x2" and start == 0:
                s = torch.cat([2 * s[:1], s[1:]])
            out.append(s.reshape(b, chunk).float().cpu().numpy()[:, :actions - start])
        committed = committed_state(caches, list(taken) + [chosen], grasps, self.fingers)
        obs = self.scores(img, gt, committed, gen).float().cpu().numpy()
        return np.concatenate(out, axis=1), obs
