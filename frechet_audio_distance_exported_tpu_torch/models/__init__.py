"""Audio embedding models (torch) and the frontend re-exports.

The counterpart of frechet_audio_distance_exported_tpu/models/__init__.py,
with the same names and constants. Where the JAX package exports a forward
function and a parameter initialiser per family (vggish_forward and
init_vggish_params, ...), this package exports the nn.Module that holds
both: VGGish, PANN, CLAP and Encodec, with encodec_for_rate for the 24 kHz
(mono, causal) or 48 kHz (stereo, GroupNorm) encoder, and WavLM, which the
JAX package does not have. Random weights come
from utils.weights.init_random_params, real ones from a bundle through
FrechetAudioDistance.
"""

from .clap import CLAP, EMBEDDING_SIZE as CLAP_EMBEDDING_SIZE
from .encodec import EMBEDDING_SIZE as ENCODEC_EMBEDDING_SIZE
from .encodec import Encodec, encodec_for_rate
from .pann import PANN, EMBEDDING_SIZE as PANN_EMBEDDING_SIZE
from .vggish import VGGish, EMBEDDING_SIZE as VGGISH_EMBEDDING_SIZE
from .wavlm import WavLM, EMBEDDING_SIZE as WAVLM_EMBEDDING_SIZE
from ..ops.frontends import (
    CLAP_MAX_AUDIO_SECONDS,
    CLAP_MAX_SAMPLES,
    CLAP_SAMPLE_RATE,
    ENCODEC_CONFIGS,
    ENCODEC_MAX_AUDIO_SECONDS,
    PANN_CONFIGS,
    pad_audio_to_max_length as pad_clap_audio_to_max_length,
    pad_to_fixed_length as pad_to_fixed_encodec_length,
    pad_to_valid_encodec_length,
    preprocess_for_clap,
    preprocess_for_encodec,
    waveform_to_examples,
    waveform_to_logmel,
)

ENCODEC_MAX_SAMPLES_24K = ENCODEC_MAX_AUDIO_SECONDS * 24000
ENCODEC_MAX_SAMPLES_48K = ENCODEC_MAX_AUDIO_SECONDS * 48000

__all__ = [
    "VGGish",
    "VGGISH_EMBEDDING_SIZE",
    "PANN",
    "PANN_EMBEDDING_SIZE",
    "Encodec",
    "encodec_for_rate",
    "CLAP",
    "WavLM",
    "WAVLM_EMBEDDING_SIZE",
    "waveform_to_examples",
    "waveform_to_logmel",
    "PANN_CONFIGS",
    "ENCODEC_CONFIGS",
    "ENCODEC_EMBEDDING_SIZE",
    "ENCODEC_MAX_AUDIO_SECONDS",
    "ENCODEC_MAX_SAMPLES_24K",
    "ENCODEC_MAX_SAMPLES_48K",
    "preprocess_for_encodec",
    "pad_to_fixed_encodec_length",
    "pad_to_valid_encodec_length",
    "CLAP_SAMPLE_RATE",
    "CLAP_EMBEDDING_SIZE",
    "CLAP_MAX_AUDIO_SECONDS",
    "CLAP_MAX_SAMPLES",
    "preprocess_for_clap",
    "pad_clap_audio_to_max_length",
]
