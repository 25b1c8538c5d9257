"""Whether the window's answers are right.

Each call of the window returns a distance, and hands the program's
statistics of its two directories, (mu, sigma) each, to the calculator's
``calculate_frechet_distance`` hook. The plain reference (fadbench/reference/)
embeds every pool clip from the int16 arrays the benchmark generated, with
the benchmark's own weights, in float32 with TF32 off; takes each call's
mean and covariance over the same clips in float64; and computes the
distance. Three numbers, each the worst over the window's calls, are held
to the cell's limits (fadbench/limits/<cell>.json):

- ``fad_rel``: |FAD - FAD_ref| / FAD_ref;
- ``mean_rel``: |mu - mu_ref| / sqrt(trace sigma_ref), the mean's error in
  units of the rows' spread;
- ``cov_rel``: |sigma - sigma_ref|_F / |sigma_ref|_F.

A call that failed, or that gave no statistics, has no answer, and the run
is not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference import stats

NUMBERS = ("fad_rel", "mean_rel", "cov_rel")
BLOCK_CLIPS = 64


def reference_rows(cell, pools: Dict[str, np.ndarray], weight_seed: int, device) -> dict:
    """{side: float32 [clips, rows, d]} of every pool clip, on ``device``."""
    ref = cell.reference()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = ref.build(cell.config, device)
        gen = torch.Generator(device=device).manual_seed(weight_seed)
        model.load_state_dict(ref.init_state(cell.config, gen, device))
        rows = {}
        with torch.inference_mode():
            for side, pcm in pools.items():
                rows[side] = torch.cat([
                    ref.embed(model, torch.from_numpy(pcm[b0 : b0 + BLOCK_CLIPS]).to(device))
                    for b0 in range(0, len(pcm), BLOCK_CLIPS)
                ])
        return rows
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def readings(calls: List[dict], rows: dict) -> Dict[str, float]:
    """The three numbers, worst over ``calls`` that returned statistics."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for call in calls:
        ref = {}
        for side in ("background", "eval"):
            r = rows[side][torch.as_tensor(call["pair"][side], device=rows[side].device)]
            ref[side] = stats.mean_cov(r.reshape(-1, r.shape[-1]))
        fad_ref = stats.frechet_distance(*ref["background"], *ref["eval"])
        got = {"background": call["stats"][0:2], "eval": call["stats"][2:4]}
        values = {"fad_rel": abs(call["value"] - fad_ref) / abs(fad_ref), "mean_rel": 0.0,
                  "cov_rel": 0.0}
        for side, (mu_r, sigma_r) in ref.items():
            mu, sigma = (np.asarray(a, np.float64) for a in got[side])
            spread = math.sqrt(np.trace(sigma_r))
            values["mean_rel"] = max(values["mean_rel"], np.linalg.norm(mu - mu_r) / spread)
            values["cov_rel"] = max(values["cov_rel"],
                                    np.linalg.norm(sigma - sigma_r) / np.linalg.norm(sigma_r))
        for k, v in values.items():
            # NaN stays NaN, and fails every limit.
            worst[k] = v if (math.isnan(v) or v > worst[k]) else worst[k]
    return {k: float(v) for k, v in worst.items()}


def decide(limits: dict, values: Dict[str, float], answered: bool) -> tuple:
    """(correct, {number: {"value", "limit"}})."""
    checks = {k: {"value": values.get(k, float("nan")), "limit": limits[k]} for k in NUMBERS}
    ok = answered and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
