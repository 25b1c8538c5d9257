"""Reference torch artifacts -> the JAX-layout parameter trees, in process.

The port's copy of tools/extract_weights.py (L33-284): `_load_state_dict`
(a torch.export .pt2 or a TorchScript .pt), `_load_plain_checkpoint` (a
.pth state dict, loaded with weights_only=True), and the four extract_*
functions. Each returns the JAX package's parameter tree (NHWC / HWIO /
WIO / [in, out] numpy leaves), which utils/weights.params_from_jax turns
into the torch modules' state_dicts and utils/weights.save_weights caches
as the .npz bundle both packages read. The code after this docstring is
verbatim; the port imports neither tools/ (its main() imports the JAX
package) nor the JAX package.
"""

from __future__ import annotations

import numpy as np


def _t(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _conv2d(sd, prefix, bias=True):
    p = {"w": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def _conv1d_from(w, b):
    return {"w": np.asarray(w).transpose(2, 1, 0), "b": np.asarray(b)}


def _linear(sd, prefix):
    return {"w": _t(sd[f"{prefix}.weight"]).T, "b": _t(sd[f"{prefix}.bias"])}


def _bn(sd, prefix):
    return {
        "gamma": _t(sd[f"{prefix}.weight"]),
        "beta": _t(sd[f"{prefix}.bias"]),
        "mean": _t(sd[f"{prefix}.running_mean"]),
        "var": _t(sd[f"{prefix}.running_var"]),
    }


def _ln(sd, prefix):
    return {"gamma": _t(sd[f"{prefix}.weight"]), "beta": _t(sd[f"{prefix}.bias"])}


def _load_state_dict(artifact_path: str):
    """state_dict from a .pt2 (torch.export) or .pt (TorchScript) artifact."""
    import torch

    if artifact_path.endswith(".pt2"):
        exported = torch.export.load(artifact_path)
        module = exported.module()
        return dict(module.state_dict()), module
    module = torch.jit.load(artifact_path, map_location="cpu")
    return dict(module.state_dict()), module


def _load_plain_checkpoint(artifact_path: str) -> dict:
    """Plain tensor state dict from a .pth checkpoint (torchvggish hub /
    Zenodo Cnn14 files are plain dicts — weights_only=True keeps a malicious
    pickle from executing code during extraction)."""
    import torch

    try:
        ckpt = torch.load(artifact_path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{artifact_path} is not a plain tensor state dict (refusing to "
            f"unpickle arbitrary objects; re-save the checkpoint as a plain "
            f"state dict with torch.save(model.state_dict(), ...)): {e}"
        ) from e
    return ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt


# ---------------------------------------------------------------------------
# VGGish (reference: models/vggish.py:54-95; conv indices 0,3,6,8,11,13 of the
# features Sequential, linears 0,2,4 of embeddings)
# ---------------------------------------------------------------------------


def extract_vggish(artifact_path: str):
    """Accepts the reference .pt2 artifact OR an upstream torchvggish hub
    checkpoint (.pth plain state dict, e.g. vggish-10086976.pth from
    harritaylor/torchvggish) — both use the same features/embeddings
    Sequential indices (reference: export_vggish.py:36-61)."""
    if artifact_path.endswith(".pth"):
        sd = _load_plain_checkpoint(artifact_path)
    else:
        sd, _ = _load_state_dict(artifact_path)
    sd = _strip_prefixes(sd)
    conv_idx = [0, 3, 6, 8, 11, 13]
    return {
        "features": [_conv2d(sd, f"features.{i}") for i in conv_idx],
        "embeddings": [_linear(sd, f"embeddings.{i}") for i in (0, 2, 4)],
    }


# ---------------------------------------------------------------------------
# PANN CNN14 (reference: models/pann.py:200-273); also accepts upstream
# Cnn14*.pth checkpoints whose keys live under 'model.' (export_pann.py:166-195)
# ---------------------------------------------------------------------------


def extract_pann(artifact_path: str):
    if artifact_path.endswith(".pth"):
        sd = _load_plain_checkpoint(artifact_path)
    else:
        sd, _ = _load_state_dict(artifact_path)
    sd = _strip_prefixes(sd)
    params = {"bn0": _bn(sd, "bn0"), "blocks": []}
    for i in range(1, 7):
        params["blocks"].append(
            {
                "conv1": _conv2d(sd, f"conv_block{i}.conv1", bias=False),
                "bn1": _bn(sd, f"conv_block{i}.bn1"),
                "conv2": _conv2d(sd, f"conv_block{i}.conv2", bias=False),
                "bn2": _bn(sd, f"conv_block{i}.bn2"),
            }
        )
    params["fc1"] = _linear(sd, "fc1")
    return params


# ---------------------------------------------------------------------------
# Encodec SEANet encoder (traced .pt; Sequential layout per Meta encodec:
# 0 conv_in, (1 res, 3 down), (4, 6), (7, 9), (10, 12), 13 lstm, 15 conv_out)
# ---------------------------------------------------------------------------


def _sconv_from_sd(sd, prefix):
    """SConv1d -> NormConv1d('conv.conv.*'); weight_norm folded if present."""
    base = f"{prefix}.conv.conv"
    if f"{base}.weight_g" in sd or f"{base}.parametrizations.weight.original0" in sd:
        if f"{base}.weight_g" in sd:
            g = _t(sd[f"{base}.weight_g"])
            v = _t(sd[f"{base}.weight_v"])
        else:  # torch >= 2.1 parametrization names
            g = _t(sd[f"{base}.parametrizations.weight.original0"])
            v = _t(sd[f"{base}.parametrizations.weight.original1"])
        norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
        w = g * v / norm
    else:
        w = _t(sd[f"{base}.weight"])
    p = _conv1d_from(w, _t(sd[f"{base}.bias"]))
    gn_w = f"{prefix}.conv.norm.weight"
    if gn_w in sd:
        p["gn"] = {"gamma": _t(sd[gn_w]), "beta": _t(sd[f"{prefix}.conv.norm.bias"])}
    return p


def extract_encodec(artifact_path: str):
    sd, _ = _load_state_dict(artifact_path)
    sd = _strip_prefixes(sd)
    # Keys may be rooted at 'model.N....' (the encoder's nn.Sequential).
    root = "model" if any(k.startswith("model.") for k in sd) else ""

    def key(i):
        return f"{root}.{i}" if root else str(i)

    params = {"conv_in": _sconv_from_sd(sd, key(0)), "stages": []}
    for s in range(4):
        res_i, down_i = 1 + 3 * s, 3 + 3 * s
        params["stages"].append(
            {
                "res": {
                    "conv1": _sconv_from_sd(sd, f"{key(res_i)}.block.1"),
                    "conv2": _sconv_from_sd(sd, f"{key(res_i)}.block.3"),
                    "shortcut": _sconv_from_sd(sd, f"{key(res_i)}.shortcut"),
                },
                "down": _sconv_from_sd(sd, key(down_i)),
            }
        )
    lstm_prefix = f"{key(13)}.lstm"
    lstm = {}
    for li, name in enumerate(("l0", "l1")):
        # DeviceAwareLSTM wrapping (export_encodec.py:72-129) nests the real
        # LSTM one level deeper; probe both.
        cand = [f"{lstm_prefix}.lstm", lstm_prefix]
        base = next(c for c in cand if f"{c}.weight_ih_l{li}" in sd)
        lstm[name] = {
            "w_ih": _t(sd[f"{base}.weight_ih_l{li}"]).T,
            "w_hh": _t(sd[f"{base}.weight_hh_l{li}"]).T,
            "b_ih": _t(sd[f"{base}.bias_ih_l{li}"]),
            "b_hh": _t(sd[f"{base}.bias_hh_l{li}"]),
        }
    params["lstm"] = lstm
    params["conv_out"] = _sconv_from_sd(sd, key(15))
    return params


# ---------------------------------------------------------------------------
# CLAP HTSAT-tiny + projection (reference: export_clap.py:88-150)
# ---------------------------------------------------------------------------


def extract_clap(artifact_path: str):
    sd, _ = _load_state_dict(artifact_path)
    sd = _strip_prefixes(sd)
    ab = "audio_branch"
    depths = (2, 2, 6, 2)
    params = {
        "bn0": _bn(sd, f"{ab}.bn0"),
        "patch_embed": {
            "conv": _conv2d(sd, f"{ab}.patch_embed.proj"),
            "norm": _ln(sd, f"{ab}.patch_embed.norm"),
        },
        "stages": [],
    }
    for i, depth in enumerate(depths):
        blocks = []
        for j in range(depth):
            b = f"{ab}.layers.{i}.blocks.{j}"
            blocks.append(
                {
                    "norm1": _ln(sd, f"{b}.norm1"),
                    "qkv": _linear(sd, f"{b}.attn.qkv"),
                    "rel_bias": _t(sd[f"{b}.attn.relative_position_bias_table"]),
                    "proj": _linear(sd, f"{b}.attn.proj"),
                    "norm2": _ln(sd, f"{b}.norm2"),
                    "mlp": {
                        "fc1": _linear(sd, f"{b}.mlp.fc1"),
                        "fc2": _linear(sd, f"{b}.mlp.fc2"),
                    },
                }
            )
        stage = {"blocks": blocks}
        if i < 3:
            d = f"{ab}.layers.{i}.downsample"
            stage["downsample"] = {
                "norm": _ln(sd, f"{d}.norm"),
                "reduction": {"w": _t(sd[f"{d}.reduction.weight"]).T},
            }
        params["stages"].append(stage)
    params["norm"] = _ln(sd, f"{ab}.norm")
    params["projection"] = {
        "fc1": _linear(sd, "audio_projection.0"),
        "fc2": _linear(sd, "audio_projection.2"),
    }
    return params


def _strip_prefixes(sd):
    """torch.export modules may prefix params (e.g. 'L__self___...' lifted
    names are NOT produced by .module().state_dict(), but '_orig_mod.' or a
    leading 'module.' can appear depending on torch version)."""
    for pref in ("_orig_mod.", "module."):
        if all(k.startswith(pref) for k in sd):
            sd = {k[len(pref):]: v for k, v in sd.items()}
    return sd


EXTRACTORS = {
    "vggish": extract_vggish,
    "pann-8k": extract_pann,
    "pann-16k": extract_pann,
    "pann-32k": extract_pann,
    "encodec-24k": extract_encodec,
    "encodec-48k": extract_encodec,
    "clap": extract_clap,
}


def extract(model_name: str, artifact_path: str):
    """Artifact -> JAX param pytree (numpy leaves)."""
    return EXTRACTORS[model_name](artifact_path)
