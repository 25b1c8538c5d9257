"""Model registry: names, sample rates, embedding dims, weight bundles.

Copied from frechet_audio_distance_exported_tpu/registry.py (L15-138) so
the port never imports the JAX package, the download URL and sha256 tables
and the reference artifacts' names included (L50-88); the PANN frontend
geometry lives in ops/frontends.PANN_CONFIGS. The port also runs a model
the JAX package does not, wavlm-large, on random weights only: no bundle or
reference artifact is published for it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# Valid model names and their configurations (reference: fad.py:109-117).
VALID_MODELS = {
    "vggish": {"sample_rate": 16000, "embedding_dim": 128},
    "pann-8k": {"sample_rate": 8000, "embedding_dim": 2048},
    "pann-16k": {"sample_rate": 16000, "embedding_dim": 2048},
    "pann-32k": {"sample_rate": 32000, "embedding_dim": 2048},
    "encodec-24k": {"sample_rate": 24000, "embedding_dim": 128, "channels": 1},
    "encodec-48k": {"sample_rate": 48000, "embedding_dim": 128, "channels": 2},
    "clap": {"sample_rate": 48000, "embedding_dim": 512},
    "wavlm-large": {"sample_rate": 16000, "embedding_dim": 1024},
}

# Map PANN model names to their sample rates (JAX registry.py:26-31).
PANN_SAMPLE_RATES = {
    "pann-8k": 8000,
    "pann-16k": 16000,
    "pann-32k": 32000,
}

# Map Encodec model names to their sample rates (JAX registry.py:33-37).
ENCODEC_SAMPLE_RATES = {
    "encodec-24k": 24000,
    "encodec-48k": 48000,
}

# Weight bundle file names: the same .npz bundles the JAX package loads.
WEIGHT_FILENAMES = {
    "vggish": "vggish_tpu.npz",
    "pann-8k": "pann_cnn14_8k_tpu.npz",
    "pann-16k": "pann_cnn14_16k_tpu.npz",
    "pann-32k": "pann_cnn14_32k_tpu.npz",
    "encodec-24k": "encodec_24k_tpu.npz",
    "encodec-48k": "encodec_48k_tpu.npz",
    "clap": "clap_tpu.npz",
}

# GitHub release URLs of the reference torch artifacts (reference:
# fad.py:95-106, EXPORTED_MODEL_URLS). On a weight-bundle cache miss, the
# artifact is downloaded here and converted in-process to .npz
# (utils/convert.py).
EXPORTED_MODEL_URLS = {
    "vggish": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.1/vggish_exported.pt2",
    "pann-8k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_8k_exported.pt2",
    "pann-16k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_16k_exported.pt2",
    "pann-32k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_32k_exported.pt2",
    "encodec-24k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/encodec_24k_exported.pt",
    "encodec-48k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/encodec_48k_exported.pt",
    "clap": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/clap_exported.pt2",
}

# Optional sha256 pins for downloaded artifacts, verified when set (the
# reference does no integrity checking; empty entries skip verification).
EXPORTED_MODEL_SHA256: dict = {}

# Direct URLs for pre-converted .npz weight bundles (torch-free install
# path). Checked before EXPORTED_MODEL_URLS; none hosted yet — populate
# when bundles are published, or point at a private mirror via code.
WEIGHT_BUNDLE_URLS: dict = {}

# Optional sha256 pins for the bundles above, verified when set (same
# semantics as EXPORTED_MODEL_SHA256).
WEIGHT_BUNDLE_SHA256: dict = {}

# The reference torch artifacts these weight bundles are converted from
# (reference: fad.py:95-106, fad.py:252-270). utils/weights.get_params
# converts these when present in ckpt_dir.
REFERENCE_ARTIFACTS = {
    "vggish": "vggish_exported.pt2",
    "pann-8k": "pann_cnn14_8k_exported.pt2",
    "pann-16k": "pann_cnn14_16k_exported.pt2",
    "pann-32k": "pann_cnn14_32k_exported.pt2",
    "encodec-24k": "encodec_24k_exported.pt",
    "encodec-48k": "encodec_48k_exported.pt",
    "clap": "clap_exported.pt2",
}


def default_ckpt_dir() -> str:
    """Default cache directory for weight bundles (shared with the JAX
    package, so one converted bundle serves both)."""
    env = os.environ.get("FAD_TPU_CKPT_DIR")
    if env:
        return env
    cache_home = os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache_home, "fad_tpu")


@dataclass(frozen=True)
class ModelConfig:
    """Resolved configuration for one model variant."""

    name: str
    sample_rate: int
    embedding_dim: int
    weight_filename: str = ""
    reference_artifact: str = ""

    @property
    def family(self) -> str:
        if self.name.startswith("pann-"):
            return "pann"
        if self.name.startswith("encodec-"):
            return "encodec"
        if self.name.startswith("wavlm-"):
            return "wavlm"
        return self.name


def get_model_config(model_name: str) -> ModelConfig:
    if model_name not in VALID_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Valid options: {list(VALID_MODELS.keys())}"
        )
    cfg = VALID_MODELS[model_name]
    return ModelConfig(
        name=model_name,
        sample_rate=cfg["sample_rate"],
        embedding_dim=cfg["embedding_dim"],
        weight_filename=WEIGHT_FILENAMES.get(model_name, ""),
        reference_artifact=REFERENCE_ARTIFACTS.get(model_name, ""),
    )


# The model names this package runs: all eight of VALID_MODELS.
PORTED_MODELS = (
    "vggish", "pann-8k", "pann-16k", "pann-32k", "encodec-24k", "encodec-48k", "clap",
    "wavlm-large",
)


def ported_model_config(model_name: str) -> ModelConfig:
    """get_model_config (same ValueError for unknown names), then
    NotImplementedError for a valid name that is not ported yet."""
    cfg = get_model_config(model_name)
    if model_name not in PORTED_MODELS:
        raise NotImplementedError(
            f"{model_name!r} is not ported to PyTorch yet (ROADMAP.md Queue 1); "
            f"ported: {list(PORTED_MODELS)}"
        )
    return cfg
