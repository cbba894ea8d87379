"""The active-touch environment: grasp selection over frozen reconstruction.

Port of the JAX package's ``active/env.py``.  Each step turns the touch
signals of a grasp into touch charts, reconstructs the surface with the
frozen deformation model, optionally embeds it with the frozen autoencoder,
and scores it with the Chamfer distance against the ground-truth cloud.
Reward = score decrease.  The greedy oracle scores K candidate grasps per
element by folding them onto the batch: one reconstruction and one exact
Chamfer distance per chunk of candidates.

Touch signals come from a per-(object, action) cache, filled from the
dataset's precomputed chart cache (``chart_cache_root``) or from the host
simulator: the env's own :class:`sim.sampler.Sampler` unless the caller
passes a ``sampler`` (any object with ``load_objects``, ``sample`` and
``disconnect``).  A pair the chart cache lacks is grasped live at its
first use, and the episode's first such miss loads the episode's objects
into the simulator: where the chart cache answers every grasp, no mesh is
loaded.

Vertex mask codes: 0 failed grasp, 1 grasp without touch (chart collapsed
to the sensor's position), 2 successful touch, 3 vision chart.

Spans (``utils/profiler.py``, recorded under a profiler): ``env.reset`` over
``env.prime_cache`` and ``env.obs``; ``env.step`` over ``env.apply_signals``
and ``env.obs``; ``env.score_candidates`` over one ``env.score_chunk`` a
chunk; the simulator's ``sim.load_objects`` under the ``env.apply_signals``
or ``env.score_chunk`` of the episode's first miss; ``env.fetch`` around
each copy from the card to the host.  Counters: ``env.resets``;
``env.signal_hits`` and ``env.signal_misses`` (a grasp's signals found in
the cache or simulated), ``env.signal_cache_clears``; ``env.sim_loads``
(the episodes whose objects the simulator loaded).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.core import touch_chart
from active_3d_vision_and_touch_tpu_torch.core.config import PolicyConfig, SimConfig
from active_3d_vision_and_touch_tpu_torch.core.device import host_to_device, resolve_device
from active_3d_vision_and_touch_tpu_torch.models.autoencoder import MeshAutoEncoder
from active_3d_vision_and_touch_tpu_torch.models.touch import TouchChartEncoder
from active_3d_vision_and_touch_tpu_torch.models.vision import (
    Deformation,
    init_modules_,
    prepare_charts,
)
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import mesh_chamfer_distance
from active_3d_vision_and_touch_tpu_torch.sim.sampler import Sampler
from active_3d_vision_and_touch_tpu_torch.train.vision import (
    build_deformation,
    deformation_geometry,
)
from active_3d_vision_and_touch_tpu_torch.utils.profiler import count, span

_CODE_OF = {"touch": 2, "no_touch": 1, "no_intersection": 0}


def _write_signals(entry, charts: np.ndarray, masks: np.ndarray) -> None:
    """Write a signal-cache entry (charts (nf, 25, 3), mask codes (nf,),
    finger positions (nf, 3)) into a chart slot (nf, 25, 3) and a mask slot
    (nf, 25, 1): code 2 takes its chart, code 1 the finger's position at
    every vertex, code 0 zeros."""
    entry_charts, codes, pos = entry
    for f, code in enumerate(codes):
        charts[f] = entry_charts[f] if code == 2 else pos[f] if code == 1 else 0
        masks[f] = code


class ActiveTouchEnv:
    def __init__(
        self,
        config: PolicyConfig,
        touch_model: TouchChartEncoder | None = None,
        vision_model: Deformation | None = None,
        auto_model: MeshAutoEncoder | None = None,
        sampler=None,
        chart_cache_root: str | None = None,
        device="cuda",
    ):
        """``touch_model``, ``vision_model`` (a ``Deformation`` of
        ``config``'s architecture) and ``auto_model`` are the frozen models,
        loaded; a touch or vision model not given is built with the weights
        drawn from ``config.seed``.  ``auto_model`` is required with
        ``config.use_latent``.  The env moves each model to its device and
        freezes it there: eval mode, no gradient."""
        self.config = config
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.steps = 0

        if touch_model is None:
            touch_model = init_modules_(TouchChartEncoder(), torch.Generator().manual_seed(config.seed))
        if vision_model is None:
            vision_model = build_deformation(config, self.device)
        self.adj_info, self.initial_mesh = deformation_geometry(config, self.device)
        self.use_latent = config.use_latent
        if self.use_latent and auto_model is None:
            raise ValueError("use_latent needs the frozen autoencoder (auto_model)")
        self.touch_model, self.deform, self.auto_model = (
            None if m is None else m.to(self.device).eval().requires_grad_(False)
            for m in (touch_model, vision_model, auto_model)
        )
        self.adj = self.adj_info.adj
        self.original_adj = self.adj_info.original
        self.faces = self.adj_info.faces
        self.chart_verts = torch.as_tensor(touch_chart().verts, device=self.device)

        self.sampler = sampler or Sampler(
            bs=config.env_batch_size, vision=False, config=SimConfig()
        )
        self._greedy_rng = np.random.default_rng(config.seed + 12345)
        self.num_fingers = config.num_fingers
        b, f, g = config.env_batch_size, self.num_fingers, config.num_grasps
        self._chart_shape = (b, f, g, 25, 3)
        self._mask_shape = (b, f, g, 25, 1)
        self.current: dict = {}

        # (object name, action) → (charts (nf, 25, 3), mask codes (nf,),
        # finger positions (nf, 3)).  The simulator is deterministic per
        # (object, action), so the oracle's repeated probes are cache hits
        self._sig_cache: dict = {}
        self._sig_cache_cap = 200_000
        # the dataset's chart cache (written by the touch-chart stage with
        # the same frozen touch model over the same grasps), per object
        self._chart_cache_root = chart_cache_root
        self._chart_cache: dict = {}
        # the names the last reset was given, and whether the simulator
        # holds their objects: loaded at the episode's first miss
        self._episode_names: list | None = None
        self._sim_loaded = False

    # ------------------------------------------------------------ device
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A float32 copy of ``arr`` on the env's device, sent without
        waiting: building the next chunk's charts on the host overlaps the
        card's work."""
        return host_to_device(arr, self.device)

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """``t`` copied to the host, which waits for the card's work queued
        before it."""
        with span("env.fetch"):
            return t.cpu().numpy()

    @torch.inference_mode()
    def _predict_touch(self, touch, pos, rot) -> torch.Tensor:
        return self.touch_model(touch, pos, rot, self.chart_verts)

    @torch.inference_mode()
    def _reconstruct(self, img, touch_charts, touch_masks, gt_points, draws=None):
        """(verts, mask, score, latent) of the current charts, on the device;
        ``draws`` (see :func:`ops.sample.draw_sample_noise`) replaces the
        sampler's draw from the env's generator."""
        b = gt_points.shape[0]
        stacked = torch.cat(
            [touch_charts.reshape(b, -1, 3), touch_masks.reshape(b, -1, 1)], dim=-1
        )
        charts = prepare_charts(stacked, self.initial_mesh, b, use_touch=True)
        verts, mask = self.deform(
            img if self.config.use_img else None, charts, self.adj, self.original_adj
        )
        score = self.config.loss_coeff * mesh_chamfer_distance(
            verts, self.faces, gt_points, self.generator,
            num=self.config.number_points, draws=draws,
        )
        latent = None
        if self.use_latent:
            latent = self.auto_model(verts, mask, self.adj, only_encode=True)
        return verts, mask, score, latent

    @torch.inference_mode()
    def _score_chunk(self, img, base_charts, base_masks, cand_charts, cand_masks, step,
                     gt_points, draws=None) -> torch.Tensor:
        """Score ``kc`` candidate actions per element in one pass, the
        candidate axis folded onto the batch.

        base: (b, nf, g, 25, ·) committed charts; cand: (b, kc, nf, 25, ·)
        per-candidate charts for grasp slot ``step``.  Returns (b, kc)
        scores, on the device."""
        b, kc = cand_charts.shape[:2]
        charts = base_charts[:, None].repeat(1, kc, 1, 1, 1, 1)  # (b, kc, nf, g, 25, 3)
        masks = base_masks[:, None].repeat(1, kc, 1, 1, 1, 1)
        if step < charts.shape[3]:
            charts[:, :, :, step] = cand_charts
            masks[:, :, :, step] = cand_masks
        bk = b * kc
        stacked = torch.cat([charts.reshape(bk, -1, 3), masks.reshape(bk, -1, 1)], dim=-1)
        prepared = prepare_charts(stacked, self.initial_mesh, bk, use_touch=True)
        img_k = img.repeat_interleave(kc, dim=0) if self.config.use_img else None
        verts, _ = self.deform(img_k, prepared, self.adj, self.original_adj)
        score = self.config.loss_coeff * mesh_chamfer_distance(
            verts, self.faces, gt_points.repeat_interleave(kc, dim=0), self.generator,
            num=self.config.number_points, draws=draws,
        )
        return score.reshape(b, kc)

    # ----------------------------------------------------------- episode
    def reset(self, batch: dict) -> dict:
        """Start an episode on a new batch of objects (dict with ``names``
        path prefixes, ``gt_points`` and optionally ``img``).  The
        simulator does not load the objects here: the episode's first
        grasp that the signal cache lacks loads the names given now."""
        c = self.config
        with span("env.reset"):
            count("env.resets")
            self.steps = 0
            self.current = {
                "batch": batch,
                "mask": np.zeros((c.env_batch_size, c.num_actions), np.float32),
                "first_score": None,
                "touch_charts": np.zeros(self._chart_shape, np.float32),
                "touch_masks": np.zeros(self._mask_shape, np.float32),
                # the episode's image and gt cloud, moved to the device once
                "gt_device": self._to_device(batch["gt_points"]),
                "img_device": self._to_device(batch["img"]) if c.use_img else None,
            }
            self._episode_names = list(batch["names"])
            self._sim_loaded = False
            if self._chart_cache_root is not None:
                with span("env.prime_cache"):
                    self._prime_signal_cache(batch["names"])
            obs = self.compute_obs()
            self.current["score"] = obs["score"]
            return obs

    def step(self, actions):
        with span("env.step"):
            actions = np.asarray(actions).reshape(-1)
            for i, a in enumerate(actions):
                self.current["mask"][i, int(a)] = 1
            obs = self.compute_obs(actions)
            reward = self.current["score"] - obs["score"]
            self.current["score"] = obs["score"]
            self.steps += 1
            done = self.steps == self.config.budget
            return obs, reward, done

    def check_step(self, actions) -> dict:
        """Score a candidate action without committing state."""
        return self.compute_obs(np.asarray(actions))

    def score_candidates(self, candidates: np.ndarray, chunk: int = 10,
                         draws: list | None = None) -> np.ndarray:
        """(b, K) candidate actions → (b, K) scores, without committing
        state: the score element i would see if it took candidates[i, j] as
        its next grasp.  Candidates fold onto the batch axis, ``chunk``
        columns a pass; a last short chunk is padded with its first column.
        The scores stay on the device until every chunk is queued, so the
        host builds chunk j+1's charts while the card scores chunk j.
        ``draws`` holds the sampler's draws for each chunk, in place of the
        env's generator."""
        with span("env.score_candidates"):
            b, k = candidates.shape
            nf = self.num_fingers
            names = self.current["batch"]["names"]
            base_charts = self._to_device(self.current["touch_charts"][:, :nf])
            base_masks = self._to_device(self.current["touch_masks"][:, :nf])
            kc = min(chunk, k)
            scores = []
            for n, start in enumerate(range(0, k, kc)):
                with span("env.score_chunk"):
                    cols = candidates[:, start : start + kc]
                    if cols.shape[1] < kc:
                        cols = np.concatenate([cols, np.repeat(cols[:, :1], kc - cols.shape[1], 1)], 1)
                    cand_charts = np.zeros((b, kc, nf, 25, 3), np.float32)
                    cand_masks = np.zeros((b, kc, nf, 25, 1), np.float32)
                    for j in range(kc):
                        keys = [(str(names[i]), int(cols[i, j])) for i in range(b)]
                        self._ensure_signals(cols[:, j], keys)
                        for i in range(b):
                            _write_signals(self._sig_cache[keys[i]], cand_charts[i, j], cand_masks[i, j])
                    scores.append(self._score_chunk(
                        self.current["img_device"], base_charts, base_masks,
                        self._to_device(cand_charts), self._to_device(cand_masks),
                        self.steps, self.current["gt_device"], None if draws is None else draws[n],
                    ))
            return self._fetch(torch.cat(scores, dim=1))[:, :k]

    def best_action(self, greedy_checks: int | None = None) -> np.ndarray:
        """Myopic-oracle action selection without committing a step: score
        candidates (all actions, or ``greedy_checks`` unseen ones drawn per
        element) and return the best unseen action per element."""
        c = self.config
        b = c.env_batch_size
        if greedy_checks is None or greedy_checks >= c.num_actions:
            candidates = np.tile(np.arange(c.num_actions), (b, 1))
        else:
            candidates = np.zeros((b, greedy_checks), int)
            for i in range(b):
                unseen = np.nonzero(self.current["mask"][i] == 0)[0]
                k = min(greedy_checks, len(unseen))
                row = (
                    self._greedy_rng.choice(unseen, size=k, replace=False)
                    if k
                    else np.empty(0, int)
                )
                if k < greedy_checks:
                    # fewer unseen actions than probe slots: pad with tried
                    # ones, which cannot win (the selection needs mask == 0)
                    seen = np.nonzero(self.current["mask"][i] != 0)[0]
                    pool = seen if len(seen) else np.arange(c.num_actions)
                    pad = self._greedy_rng.choice(pool, size=greedy_checks - k, replace=True)
                    row = np.concatenate([row, pad])
                candidates[i] = row

        scores = self.score_candidates(candidates)
        seen = self.current["mask"][np.arange(b)[:, None], candidates] != 0
        scores = np.where(seen, np.inf, scores)
        best_action = candidates[np.arange(b), np.argmin(scores, axis=1)]
        all_seen = np.isinf(scores).all(axis=1)
        return np.where(all_seen, 0, best_action)

    def best_step(self, greedy_checks: int | None = None):
        """Myopic oracle: :meth:`best_action`, then commit it."""
        best = self.best_action(greedy_checks)
        obs, reward, done = self.step(best)
        return best, obs, reward, done

    def reset_sampler(self) -> None:
        """Tear down and rebuild the host simulator's scenes and thread pool
        (the reference's pybullet memory-leak workaround,
        ``environment.py:367-373``); the next miss loads the episode's
        objects into the new one."""
        self.sampler.disconnect()
        self.sampler = Sampler(
            bs=self.config.env_batch_size, vision=False, config=SimConfig()
        )
        self._sim_loaded = False

    # ------------------------------------------------------------- signals
    def _apply_signals(self, actions) -> None:
        """Write the charts for ``actions`` into the current step's slot
        (idempotent for repeated candidate evaluation)."""
        b = self.config.env_batch_size
        actions = np.asarray(actions).reshape(-1)
        names = self.current["batch"]["names"]
        keys = [(str(names[i]), int(actions[i])) for i in range(b)]
        self._ensure_signals(actions, keys)
        for i in range(b):
            _write_signals(self._sig_cache[keys[i]], self.current["touch_charts"][i, :, self.steps],
                           self.current["touch_masks"][i, :, self.steps])

    def _prime_signal_cache(self, names) -> None:
        """Fill the signal cache for every action of the episode's objects
        from the dataset's chart cache,
        ``<root>/touch_charts/<obj>/touch_charts.npy`` of shape
        (actions, 4, 25, 4): xyz | mask code per finger and vertex.  A code-1
        slot is stored collapsed to the sensor's position, so row 0's xyz
        is the finger's position."""
        fingers = [1] if self.config.finger else list(range(4))
        for prefix in names:
            p = str(prefix)
            obj = os.path.basename(p)
            if obj not in self._chart_cache:
                f = os.path.join(self._chart_cache_root, "touch_charts", obj, "touch_charts.npy")
                arr = np.load(f).astype(np.float32) if os.path.exists(f) else None
                if arr is not None:
                    arr.setflags(write=False)
                self._chart_cache[obj] = arr
            arr = self._chart_cache[obj]
            if arr is None:
                continue
            self._bound_signal_cache()
            for a in range(min(arr.shape[0], self.config.num_actions)):
                key = (p, a)
                if key in self._sig_cache:
                    continue
                slot = arr[a][fingers]  # (nf, 25, 4)
                self._sig_cache[key] = (
                    slot[:, :, :3],
                    slot[:, 0, 3].astype(np.int8),
                    slot[:, 0, :3],
                )

    def _ensure_signals(self, actions, keys) -> None:
        """Simulate the grasps ``actions`` unless the signal cache holds
        every one of ``keys``; counts the keys found and those missing."""
        missing = sum(k not in self._sig_cache for k in keys)
        count("env.signal_hits", len(keys) - missing)
        if missing:
            count("env.signal_misses", missing)
            self._simulate_and_cache(actions, keys)

    def _bound_signal_cache(self) -> None:
        if len(self._sig_cache) > self._sig_cache_cap:
            self._sig_cache.clear()
            count("env.signal_cache_clears")

    def _simulate_and_cache(self, actions, keys) -> None:
        """Simulate the grasps ``actions`` and cache their signals, the
        episode's objects loaded into the simulator first if it lacks them."""
        b = self.config.env_batch_size
        if self._episode_names is not None and not self._sim_loaded:
            self.sampler.load_objects(self._episode_names, from_dataset=True)
            self._sim_loaded = True
            count("env.sim_loads")
        signals = self.sampler.sample(actions, touch=True)
        fingers = [1] if self.config.finger else list(range(4))
        nf = len(fingers)
        touch = signals["touch_signal"][:, fingers].reshape(b * nf, 121, 121, 3)
        pos = signals["finger_transform_pos"][:, fingers].reshape(b * nf, 3)
        rot = signals["finger_transform_rot_M"][:, fingers].reshape(b * nf, 3, 3)
        charts = self._fetch(self._predict_touch(
            self._to_device(touch / 255.0), self._to_device(pos), self._to_device(rot)
        )).reshape(b, nf, 25, 3)
        pos = pos.reshape(b, nf, 3)
        self._bound_signal_cache()
        for i, key in enumerate(keys):
            codes = np.array(
                [_CODE_OF[signals["touch_status"][i][f]] for f in fingers], np.int8
            )
            self._sig_cache[key] = (charts[i].copy(), codes, pos[i].copy())

    # ---------------------------------------------------------------- obs
    def _dispatch_obs(self):
        """Queue the reconstruction of the current chart state; returns its
        outputs on the device."""
        nf = self.num_fingers
        return self._reconstruct(
            self.current["img_device"],
            self._to_device(self.current["touch_charts"][:, :nf]),
            self._to_device(self.current["touch_masks"][:, :nf]),
            self.current["gt_device"],
        )

    def compute_obs(self, actions=None) -> dict:
        if actions is not None:
            with span("env.apply_signals"):
                self._apply_signals(np.asarray(actions))
        with span("env.obs"):
            return self._finalize_obs(self._dispatch_obs())

    def _finalize_obs(self, outputs) -> dict:
        verts, mask, score, latent = outputs
        score = self._fetch(score)
        if self.current["first_score"] is None:
            self.current["first_score"] = score.copy()
            if self.use_latent:
                self.current["first_latent"] = self._fetch(latent)
        obs = {
            "score": score.copy(),
            "first_score": self.current["first_score"].copy(),
            "mask": self.current["mask"].copy(),
            "names": self.current["batch"]["names"],
            "mesh": self._fetch(torch.cat([verts, mask], dim=-1)),
        }
        if self.use_latent:
            obs["latent"] = self._fetch(latent)
            obs["first_latent"] = self.current["first_latent"].copy()
        return obs
