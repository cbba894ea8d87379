"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's.

- ``loss_gap``: the largest |L_program - L_reference| / |L_reference| over
  the steps compared.
- ``grad_gap`` and ``change_gap`` (training): per leaf, the gap between
  the program's norm and the reference's (not the norm of their
  difference), over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf.  The first gradient is the
  one Adam got at step 1; the change is the parameters' after the steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (a bias before a BatchNorm) move by round-off alone and are left
  out of both.
"""

from __future__ import annotations

import math

import numpy as np

NEGLIGIBLE = 1e-3  # of the median leaf's first-gradient norm


def kept_leaves(ref_grad_norms: dict) -> list[str]:
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, g in ref_grad_norms.items() if g >= NEGLIGIBLE * med]


def worst_leaf(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    med = float(np.median([ref[k] for k in leaves]))
    worst, at = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def loss_gap(prog: list[float], ref: list[float]) -> float:
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    if len(prog) != len(ref) or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` as {"losses", "grad_norms", "change_norms"}."""
    leaves = kept_leaves(ref["grad_norms"])
    grad, grad_at = worst_leaf(prog["grad_norms"], ref["grad_norms"], leaves)
    change, change_at = worst_leaf(prog["change_norms"], ref["change_norms"], leaves)
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": grad,
        "change_gap": change,
        "_leaves": {"grad_gap": grad_at, "change_gap": change_at,
                    "left_out": sorted(set(ref["grad_norms"]) - set(leaves))},
    }


def greedy_numbers(steps: list) -> dict:
    """``steps`` as dicts of the program's ``scores`` (b, A), ``obs`` (b,)
    and ``chosen`` (b,), the reference's ``ref_scores`` and ``ref_obs``, and
    ``seen`` (b, A), the actions taken before the step.

    - ``score_gap``: the largest |S_program - S_reference| / |S_reference|
      over every candidate's score and every observation's.
    - ``choice_gap``: the largest gap by which the reference's score of the
      program's choice lies above the reference's best over the actions not
      yet taken, over that best."""
    score = choice = 0.0
    for s in steps:
        for prog, ref in ((s["scores"], s["ref_scores"]), (s["obs"], s["ref_obs"])):
            gap = np.abs(np.asarray(prog, np.float64) - ref) / np.abs(ref)
            if gap.shape != np.shape(ref) or not np.isfinite(gap).all():
                return {"score_gap": math.inf, "choice_gap": math.inf}
            score = max(score, float(gap.max()))
        ref = np.where(s["seen"], np.inf, s["ref_scores"])
        best = ref.min(axis=1)
        picked = ref[np.arange(len(best)), s["chosen"]]
        choice = max(choice, float(((picked - best) / np.abs(best)).max()))
    return {"score_gap": score, "choice_gap": choice}


def _relative(prog, ref) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return math.inf
    gap = np.abs(prog - ref) / np.abs(ref)
    return float(gap.max()) if np.isfinite(gap).all() else math.inf


def ddqn_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """``prog`` and ``ref`` as {"obs": [{"scores": (previous, this) (b,),
    "latents": (previous, this) (b, L), "reward": (b,)}], "losses": each
    update's loss, "after": {updates: {leaf: tensor}}}, the parameters after
    that many updates; ``start``, the seeded parameters both trainings
    start from.

    - ``score_gap``: the largest relative gap of an observation's score.
    - ``latent_gap``: the largest ||l_program - l_reference|| / ||l_reference||
      of an observation's latent.
    - ``reward_gap``: the largest |r_program - r_reference| over the
      reference's score after the step.
    - ``loss_gap``: the largest relative gap of an update's loss, over every
      update from the first.
    - ``change_gap``: per leaf, the gap between the norms of the program's
      and the reference's change from ``start``, over the reference's norm
      of that leaf or of the median leaf, whichever is larger; the worst
      leaf at any of the kept points.
    """
    score = latent = reward = 0.0
    names = ("score_gap", "latent_gap", "reward_gap", "loss_gap", "change_gap")
    if (len(prog["obs"]) != len(ref["obs"]) or len(prog["losses"]) != len(ref["losses"])
            or set(prog["after"]) != set(ref["after"])):
        return dict.fromkeys(names, math.inf)
    for p, r in zip(prog["obs"], ref["obs"]):
        for ps, rs in zip(p["scores"], r["scores"]):
            score = max(score, _relative(ps, rs))
        for pl, rl in zip(p["latents"], r["latents"]):
            pl, rl = np.asarray(pl, np.float64), np.asarray(rl, np.float64)
            gap = np.linalg.norm(pl - rl, axis=-1) / np.linalg.norm(rl, axis=-1)
            latent = max(latent, float(gap.max()) if np.isfinite(gap).all() else math.inf)
        gap = np.abs(np.asarray(p["reward"], np.float64) - r["reward"]) / np.abs(r["scores"][1])
        reward = max(reward, float(gap.max()) if np.isfinite(gap).all() else math.inf)
    loss = _relative(prog["losses"], ref["losses"]) if prog["losses"] else 0.0
    change = 0.0
    for at in prog["after"]:
        norms = [{k: float((side["after"][at][k].float() - start[k].float()).norm()) for k in start}
                 for side in (prog, ref)]
        change = max(change, worst_leaf(norms[0], norms[1], list(start))[0])
    return dict(zip(names, (score, latent, reward, loss, change)))
