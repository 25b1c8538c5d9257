"""Weights: the JAX package's .npz bundles -> the torch module's state_dict.

The bundles are the ones frechet_audio_distance_exported_tpu/utils/weights.py
(L21-64) writes: flat keys such as "features/0/w" over the JAX pytree
{"features": [{"w": HWIO, "b"}] x 6, "embeddings": [{"w": [in, out], "b"}] x 3}.
Layouts are converted once, here: convolution HWIO -> OIHW, linear
[in, out] -> [out, in].
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from .. import registry
from ..models.vggish import CONV_CFG, FC_DIMS


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX VGGish pytree of arrays -> VGGish state_dict (float32, CPU)."""
    state = {}
    for i, p in enumerate(tree["features"]):
        state[f"features.{i}.weight"] = _f32(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        state[f"features.{i}.bias"] = _f32(p["b"])
    for i, p in enumerate(tree["embeddings"]):
        state[f"embeddings.{i}.weight"] = _f32(np.asarray(p["w"]).T)
        state[f"embeddings.{i}.bias"] = _f32(p["b"])
    return state


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A VGGish .npz bundle -> state_dict."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree: dict = {"features": [], "embeddings": []}
    for group in tree:
        i = 0
        while f"{group}/{i}/w" in flat:
            tree[group].append({"w": flat[f"{group}/{i}/w"], "b": flat[f"{group}/{i}/b"]})
            i += 1
    return params_from_jax(tree)


def init_random_params(model_name: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Torch-default-like uniform(±1/sqrt(fan_in)) weights from an explicit
    generator (tests and benches). Not the JAX package's bits."""
    registry.ported_model_config(model_name)
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, fan_in):
        bound = float(np.sqrt(1.0 / fan_in))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    state = {}
    cin = 1
    for i, cout in enumerate(v for v in CONV_CFG if v != "M"):
        state[f"features.{i}.weight"] = uniform((cout, cin, 3, 3), 9 * cin)
        state[f"features.{i}.bias"] = uniform((cout,), 9 * cin)
        cin = cout
    for i, (din, dout) in enumerate(FC_DIMS):
        state[f"embeddings.{i}.weight"] = uniform((dout, din), din)
        state[f"embeddings.{i}.bias"] = uniform((dout,), din)
    return state


def get_params(model_name: str, ckpt_dir: str, weights: str = "auto", seed: int = 0):
    """Resolve a state_dict: weights='random' draws one from ``seed``;
    weights='auto' loads <ckpt_dir>/<bundle>.npz (downloading and artifact
    conversion are not ported yet)."""
    if weights == "random":
        return init_random_params(model_name, seed)
    if weights != "auto":
        raise ValueError(f"weights must be 'auto' or 'random', got {weights!r}")
    cfg = registry.get_model_config(model_name)
    bundle_path = os.path.join(ckpt_dir, cfg.weight_filename)
    if not os.path.exists(bundle_path):
        raise FileNotFoundError(
            f"Weight bundle not found at {bundle_path}. Convert it with the JAX "
            f"package's tools/extract_weights.py --model {model_name} --ckpt-dir "
            f"{ckpt_dir}, or pass weights='random' for testing."
        )
    try:
        return load_weights(bundle_path)
    except Exception as e:
        # A corrupt bundle must not fail with a cryptic np.load error: name
        # the file and the fix.
        raise RuntimeError(
            f"Weight bundle {bundle_path} exists but failed to load "
            f"({type(e).__name__}: {e}). Delete it and convert it again."
        ) from e
