"""Weights: the JAX package's .npz bundles -> the torch modules' state_dicts.

The bundles are the ones frechet_audio_distance_exported_tpu/utils/weights.py
(L21-64) writes: flat keys such as "features/0/w" or "blocks/3/conv1/w" over
the JAX pytrees
- VGGish: {"features": [{"w": HWIO, "b"}] x 6, "embeddings": [{"w": [in, out], "b"}] x 3};
- PANN:   {"bn0": {gamma, beta, mean, var}, "blocks": [{"conv1": {"w"}, "bn1",
           "conv2": {"w"}, "bn2"}] x 6, "fc1": {"w", "b"}};
- CLAP:   {"bn0", "patch_embed": {"conv", "norm"}, "stages": [{"blocks": [...],
           "downsample"}] x 4, "norm", "projection"} (JAX models/clap.py:428-490);
- Encodec: {"conv_in", "stages": [{"res": {"conv1", "conv2", "shortcut"},
           "down"}] x 4, "lstm": {"l0", "l1"}, "conv_out"}, each conv {"w", "b"}
           and, at 48 kHz, "gn": {gamma, beta} (JAX models/encodec.py:276-311).
Layouts are converted once, here. VGGish and PANN: convolution HWIO -> OIHW,
linear [in, out] -> [out, in], BatchNorm (gamma, beta, mean, var) ->
(weight, bias, running_mean, running_var). CLAP keeps the JAX tree: its
state_dict keys are the flat keys with "." for "/", and only the patch-embed
convolution turns HWIO -> OIHW. Encodec: convolution [k, in, out] ->
[out, in, k], GroupNorm (gamma, beta) -> (weight, bias), LSTM [in, 4H] ->
nn.LSTM's [4H, in] (the gate order i, f, g, o is the same).

On a cache miss, get_params downloads a bundle or the reference artifact
and converts the artifact in process (JAX utils/weights.py:103-193), and
save_weights writes the bundle in the JAX package's format. WavLM-Large,
which the JAX package does not run, has no bundle: random weights only.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from .. import registry
from ..models import encodec, wavlm
from ..models.clap import CLAP
from ..models.pann import BLOCK_CHANNELS
from ..models.vggish import CONV_CFG, FC_DIMS
from . import convert, download


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def _batch_norm(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _f32(p["gamma"]),
        f"{prefix}.bias": _f32(p["beta"]),
        f"{prefix}.running_mean": _f32(p["mean"]),
        f"{prefix}.running_var": _f32(p["var"]),
        f"{prefix}.num_batches_tracked": torch.zeros((), dtype=torch.int64),
    }


def _vggish_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    state = {}
    for i, p in enumerate(tree["features"]):
        state[f"features.{i}.weight"] = _f32(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        state[f"features.{i}.bias"] = _f32(p["b"])
    for i, p in enumerate(tree["embeddings"]):
        state[f"embeddings.{i}.weight"] = _f32(np.asarray(p["w"]).T)
        state[f"embeddings.{i}.bias"] = _f32(p["b"])
    return state


def _pann_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    state = _batch_norm("bn0", tree["bn0"])
    for i, blk in enumerate(tree["blocks"]):
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            w = np.asarray(blk[conv]["w"]).transpose(3, 2, 0, 1)
            state[f"blocks.{i}.{conv}.weight"] = _f32(w)
            state.update(_batch_norm(f"blocks.{i}.{bn}", blk[bn]))
    state["fc1.weight"] = _f32(np.asarray(tree["fc1"]["w"]).T)
    state["fc1.bias"] = _f32(tree["fc1"]["b"])
    return state


def _clap_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    state = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            state[prefix] = _f32(node)
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    conv_w = np.asarray(tree["patch_embed"]["conv"]["w"])
    state["patch_embed.conv.w"] = _f32(conv_w.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    return state


def _encodec_state(tree: Mapping) -> Dict[str, torch.Tensor]:
    state = {}

    def sconv(prefix, p):
        state[f"{prefix}.conv.weight"] = _f32(np.asarray(p["w"]).transpose(2, 1, 0))
        state[f"{prefix}.conv.bias"] = _f32(p["b"])
        if "gn" in p:
            state[f"{prefix}.gn.weight"] = _f32(p["gn"]["gamma"])
            state[f"{prefix}.gn.bias"] = _f32(p["gn"]["beta"])

    sconv("conv_in", tree["conv_in"])
    for i, stage in enumerate(tree["stages"]):
        for name in ("conv1", "conv2", "shortcut"):
            sconv(f"stages.{i}.res.{name}", stage["res"][name])
        sconv(f"stages.{i}.down", stage["down"])
    for i in range(encodec.LSTM_LAYERS):
        p = tree["lstm"][f"l{i}"]
        state[f"lstm.weight_ih_l{i}"] = _f32(np.asarray(p["w_ih"]).T)
        state[f"lstm.weight_hh_l{i}"] = _f32(np.asarray(p["w_hh"]).T)
        state[f"lstm.bias_ih_l{i}"] = _f32(p["b_ih"])
        state[f"lstm.bias_hh_l{i}"] = _f32(p["b_hh"])
    sconv("conv_out", tree["conv_out"])
    return state


def family_of_tree(tree: Mapping) -> str:
    """'vggish', 'pann', 'encodec' or 'clap', from the pytree's top-level keys."""
    if "features" in tree and "embeddings" in tree:
        return "vggish"
    # Before CLAP's rule: both trees have "stages".
    if {"conv_in", "stages", "lstm", "conv_out"} <= set(tree):
        return "encodec"
    if "patch_embed" in tree and "stages" in tree and "projection" in tree:
        return "clap"
    if "blocks" in tree and "bn0" in tree:
        return "pann"
    raise ValueError(f"not a VGGish, PANN, Encodec or CLAP parameter tree (keys {sorted(tree)})")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX VGGish, PANN, Encodec or CLAP pytree of arrays -> the module's
    state_dict (float32, CPU)."""
    return {
        "vggish": _vggish_state, "pann": _pann_state, "encodec": _encodec_state,
        "clap": _clap_state,
    }[family_of_tree(tree)](tree)


def _unflatten(flat: Mapping[str, np.ndarray]):
    """Flat "a/0/b" keys -> nested dicts, with lists for exactly the
    contiguous digit keys '0'..'n-1' (JAX utils/weights.py:34-54)."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX-layout tree -> flat "a/0/b" keys (JAX utils/weights.py:21-31)."""
    out = {}
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix.rstrip("/"): np.asarray(params)}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}{k}/"))
    return out


def save_weights(path: str, params) -> None:
    """Write a JAX-layout tree as the .npz bundle both packages load (JAX
    utils/weights.py:56-58)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(params).items()})


def load_weights(path: str, family: str = None) -> Dict[str, torch.Tensor]:
    """A VGGish, PANN, Encodec or CLAP .npz bundle -> state_dict. With ``family`` given, a
    bundle of another family raises ValueError."""
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    found = family_of_tree(tree)
    if family is not None and found != family:
        raise ValueError(f"{path} holds {found} weights, not {family}")
    return params_from_jax(tree)


def _clap_random(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """As the JAX initializer (models/clap.py:424-490): weights and the
    relative-position tables trunc-normal with std 0.02 cut at 2 std, biases
    zero, LayerNorms and bn0 the identity."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in CLAP().state_dict().items()}
    state = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("gamma", "var"):
            state[key] = torch.ones(shape)
        elif leaf in ("beta", "mean", "b"):
            state[key] = torch.zeros(shape)
        else:  # "w" and "rel_bias"
            state[key] = torch.nn.init.trunc_normal_(
                torch.empty(shape), std=0.02, a=-0.04, b=0.04, generator=gen
            )
    return state


def _encodec_random(model_name: str, uniform) -> Dict[str, torch.Tensor]:
    """As the JAX initializer (models/encodec.py:276-311, common.py:175):
    convolutions uniform(±1/sqrt(k * in)), the LSTM uniform(±1/sqrt(512)),
    GroupNorm the identity. uniform(shape, fan_in) draws the values."""
    with torch.device("meta"):
        module = encodec.encodec_for_rate(registry.get_model_config(model_name).sample_rate)
    state = {}
    for name, mod in module.named_modules():
        if isinstance(mod, torch.nn.Conv1d):
            fan_in = mod.in_channels * mod.kernel_size[0]
            state[f"{name}.weight"] = uniform(tuple(mod.weight.shape), fan_in)
            state[f"{name}.bias"] = uniform(tuple(mod.bias.shape), fan_in)
        elif isinstance(mod, torch.nn.GroupNorm):
            state[f"{name}.weight"] = torch.ones(mod.num_channels)
            state[f"{name}.bias"] = torch.zeros(mod.num_channels)
        elif isinstance(mod, torch.nn.LSTM):
            for key, value in mod.named_parameters():
                state[f"{name}.{key}"] = uniform(tuple(value.shape), mod.hidden_size)
    return state


def _wavlm_random(uniform, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """PyTorch's default initialisation of the modules HF's WavLM builds
    them from: convolution and linear weights and biases uniform(+-1/sqrt(
    fan_in)), LayerNorms the identity, the relative-position table N(0, 1),
    gru_rel_pos_const 1, and the positional convolution's weight_g the norm
    of weight_v at each tap (weight_norm's start)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in wavlm.WavLM().state_dict().items()}
    state = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("layer_norm.weight") or leaf == "gate_const":
            state[key] = torch.ones(shape)
        elif key.endswith("layer_norm.bias"):
            state[key] = torch.zeros(shape)
        elif leaf == "rel_attn_embed":
            state[key] = torch.randn(shape, generator=gen)
        elif leaf == "weight_g":
            continue  # after weight_v, below
        elif leaf == "b":
            state[key] = uniform(shape, shapes[key[:-1] + "w"][0])
        elif leaf == "w":
            state[key] = uniform(shape, shape[0])
        else:  # convolution weights [out, in / groups, k] and the positional conv's bias
            w = shapes[key.replace("bias", "weight_v")] if leaf == "bias" else shape
            state[key] = uniform(shape, w[1] * w[2])
    for key in shapes:
        if key.endswith("weight_g"):
            v = state[key[:-1] + "v"]
            state[key] = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return {k: state[k] for k in shapes}


def check_encodec_bundle(state: Mapping[str, torch.Tensor], model_name: str, path: str) -> None:
    """Raise ValueError, naming the file, where an Encodec bundle is of the
    other rate: 48 kHz has GroupNorm leaves and 2 input channels, 24 kHz
    neither."""
    want = registry.VALID_MODELS[model_name]["channels"]
    channels = state["conv_in.conv.weight"].shape[1]
    group_norm = "conv_in.gn.weight" in state
    if channels != want or group_norm != (want == 2):
        raise ValueError(
            f"{path} holds Encodec weights for {channels} input channel(s) "
            f"{'with' if group_norm else 'without'} GroupNorm, not {model_name}'s "
            f"({want} channel(s), {'with' if want == 2 else 'without'} GroupNorm)"
        )


def init_random_params(model_name: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Weights from an explicit generator; not the JAX package's bits. VGGish,
    PANN and Encodec: torch-default-like uniform(±1/sqrt(fan_in)), BatchNorm
    and GroupNorm as the identity like the JAX initializer
    (models/common.py:194); Encodec's LSTM as _encodec_random. CLAP: as
    _clap_random. WavLM: as _wavlm_random."""
    family = registry.ported_model_config(model_name).family
    gen = torch.Generator().manual_seed(seed)
    if family == "clap":
        return _clap_random(gen)

    def uniform(shape, fan_in):
        bound = float(np.sqrt(1.0 / fan_in))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    if family == "encodec":
        return _encodec_random(model_name, uniform)
    if family == "wavlm":
        return _wavlm_random(uniform, gen)

    def identity_bn(prefix, dim):
        ones, zeros = np.ones(dim, np.float32), np.zeros(dim, np.float32)
        return _batch_norm(prefix, {"gamma": ones, "beta": zeros, "mean": zeros, "var": ones})

    state = {}
    if family == "pann":
        state.update(identity_bn("bn0", 64))
        for i, (cin, cout) in enumerate(BLOCK_CHANNELS):
            state[f"blocks.{i}.conv1.weight"] = uniform((cout, cin, 3, 3), 9 * cin)
            state.update(identity_bn(f"blocks.{i}.bn1", cout))
            state[f"blocks.{i}.conv2.weight"] = uniform((cout, cout, 3, 3), 9 * cout)
            state.update(identity_bn(f"blocks.{i}.bn2", cout))
        width = BLOCK_CHANNELS[-1][1]
        state["fc1.weight"] = uniform((width, width), width)
        state["fc1.bias"] = uniform((width,), width)
        return state
    cin = 1
    for i, cout in enumerate(v for v in CONV_CFG if v != "M"):
        state[f"features.{i}.weight"] = uniform((cout, cin, 3, 3), 9 * cin)
        state[f"features.{i}.bias"] = uniform((cout,), 9 * cin)
        cin = cout
    for i, (din, dout) in enumerate(FC_DIMS):
        state[f"embeddings.{i}.weight"] = uniform((dout, din), din)
        state[f"embeddings.{i}.bias"] = uniform((dout,), din)
    return state


def _load_bundle(model_name: str, cfg, bundle_path: str) -> Dict[str, torch.Tensor]:
    try:
        state = load_weights(bundle_path, cfg.family)
    except Exception as e:
        # A corrupt bundle must not fail with a cryptic np.load error: name
        # the file and the fix.
        raise RuntimeError(
            f"Weight bundle {bundle_path} exists but failed to load "
            f"({type(e).__name__}: {e}). Delete it to download or convert it again."
        ) from e
    if cfg.family == "encodec":
        check_encodec_bundle(state, model_name, bundle_path)
    return state


def get_params(model_name: str, ckpt_dir: str, weights: str = "auto", seed: int = 0):
    """Resolve a state_dict (JAX utils/weights.py:103-193).

    weights='auto': load <ckpt_dir>/<bundle>.npz; on a miss, try in order a
    hosted .npz bundle URL (registry.WEIGHT_BUNDLE_URLS), a reference torch
    artifact already in ckpt_dir, then downloading the reference artifact
    (registry.EXPORTED_MODEL_URLS, the reference's download-on-miss,
    reference: fad.py:275-286). An artifact is converted in process
    (utils/convert.py) and cached as the .npz bundle both packages read;
    otherwise raise, naming the file, FAD_TPU_OFFLINE and the failed
    attempts. weights='random' draws a state_dict from ``seed``.
    """
    if weights == "random":
        return init_random_params(model_name, seed)
    if weights != "auto":
        raise ValueError(f"weights must be 'auto' or 'random', got {weights!r}")
    cfg = registry.ported_model_config(model_name)
    if not cfg.weight_filename:
        raise ValueError(f"{model_name} has no published weight bundle; pass weights='random'")
    bundle_path = os.path.join(ckpt_dir, cfg.weight_filename)
    if os.path.exists(bundle_path):
        return _load_bundle(model_name, cfg, bundle_path)

    download_errors = []
    bundle_url = registry.WEIGHT_BUNDLE_URLS.get(model_name)
    if bundle_url and not download.offline():
        try:
            print(f"[FAD-TORCH] Downloading {model_name} weight bundle to {ckpt_dir}...")
            download.download_url_to_file(
                bundle_url, bundle_path, sha256=registry.WEIGHT_BUNDLE_SHA256.get(model_name)
            )
            return _load_bundle(model_name, cfg, bundle_path)
        except Exception as e:  # fall through to the artifact path
            download_errors.append(f"bundle {bundle_url}: {e}")
            if os.path.exists(bundle_path):
                os.remove(bundle_path)  # don't poison future runs

    artifact_path = os.path.join(ckpt_dir, cfg.reference_artifact)
    if not os.path.exists(artifact_path):
        artifact_url = registry.EXPORTED_MODEL_URLS.get(model_name)
        if artifact_url and not download.offline():
            try:
                print(f"[FAD-TORCH] Downloading {model_name} reference artifact to {ckpt_dir}...")
                download.download_url_to_file(
                    artifact_url, artifact_path,
                    sha256=registry.EXPORTED_MODEL_SHA256.get(model_name),
                )
                print("[FAD-TORCH] Download complete.")
            except Exception as e:
                download_errors.append(f"artifact {artifact_url}: {e}")
    if os.path.exists(artifact_path):
        save_weights(bundle_path, convert.extract(model_name, artifact_path))
        return _load_bundle(model_name, cfg, bundle_path)

    detail = ""
    if download.offline():
        detail = " Downloads are disabled (FAD_TPU_OFFLINE is set)."
    elif download_errors:
        detail = " Download attempts failed: " + "; ".join(download_errors) + "."
    raise FileNotFoundError(
        f"Weight bundle not found at {bundle_path} and no reference artifact "
        f"({cfg.reference_artifact}) to convert in {ckpt_dir}.{detail} Place either "
        f"file there, or pass weights='random' for testing."
    )
