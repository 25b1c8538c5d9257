"""The port's numerics modes against the JAX package's, on the CPU.

- The knobs: every accepted spelling and a typo of FAD_TPU_PRECISION,
  FAD_TPU_MODEL_DTYPE, FAD_TPU_LSTM_MATMUL and FAD_TPU_FUSED_BLOCK, alone
  and combined, resolve in the port (config.py) as the JAX package's
  config resolves them on its CPU backend, and raise where it raises. One
  difference is by design: an unset FAD_TPU_PRECISION is 'high' in JAX
  (exact float32 on its CPU backend) and 'highest' in the port (exact
  float32, TF32 off).
- cast_model: the parameters and buffers each family keeps in float32 are
  those JAX cast_model_params keeps (Encodec's lstm and conv_out; nothing
  else), plus CLAP's constants (bicubic taps, shift masks), which the JAX
  package keeps out of its parameter tree; encodec-48k stays float32 unless
  FAD_TPU_MODEL_DTYPE is set.
- Each torch module that runs in a bf16 model against the JAX helper it
  stands for (models/common.py), in bf16: where torch rounds. A convolution
  or linear layer adds its bias before its one rounding, where JAX rounds
  the product and then the sum; the two are at most one bf16 ulp apart,
  and the product alone (no bias) is JAX's bit for bit.
- The plain bf16 Swin versions (ops/window_attn.py) against the JAX Pallas
  kernels in interpret mode with bf16 inputs, at stages 1, 3 and 4. Both
  round at the same points and form every product from bf16 operands with
  float32 sums; they differ in float32 summation order, which moves a value
  across a bf16 rounding boundary now and then, and in the Pallas kernel's
  polynomial erf (1.5e-7 from erf). Bound: 2 bf16 ulps of the output's
  largest magnitude, and 90 % of the elements within one ulp of their own
  (measured: at most 1 ulp; 95.5-99.98 %).
- Whole-model bf16 embeddings against the JAX package's bf16 path (VGGish,
  a narrow PANN, CLAP with JAX's XLA attention, encodec-24k mixed). The two
  frameworks round at slightly different points (the bias above; XLA on the
  CPU may keep float32 across fused elementwise steps), so the rows differ
  by bf16 rounding noise: bound 2.5e-2 of the largest value, and no more
  than twice JAX's bf16 rows differ from the float32 ones (the port's
  float32 forward, which the model tests hold to JAX's within 1e-4). The
  weights are drawn with numpy in the JAX trees' layout. The FAD of two
  corpora in bf16 mode agrees within 1e-3 absolute, and relative to it
  within twice JAX's own bf16-vs-float32 delta.
- The bf16-operand LSTM (FAD_TPU_LSTM_MATMUL=bfloat16) against JAX
  _slstm(op_dtype=bfloat16): atol 1e-4, as the float32 LSTM test.
- FAD_TPU_FUSED_BLOCK=0 routing, with spies on the window kernels.
The bf16 kernels and the CUDA graph of the LSTM run on the card only: their
cases carry the `cuda` marker and skip without one.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu import config as jconfig  # noqa: E402
from frechet_audio_distance_exported_tpu import pipeline as jpipeline  # noqa: E402
from frechet_audio_distance_exported_tpu.models import clap as jclap  # noqa: E402
from frechet_audio_distance_exported_tpu.models import common as jcommon  # noqa: E402
from frechet_audio_distance_exported_tpu.models import encodec as jencodec  # noqa: E402
from frechet_audio_distance_exported_tpu.models import pann as jpann  # noqa: E402
from frechet_audio_distance_exported_tpu.models import vggish as jvggish  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import pallas_window_attn as jkernels  # noqa: E402
from frechet_audio_distance_exported_tpu_torch import config, pipeline  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.models import (  # noqa: E402
    CLAP,
    PANN,
    VGGish,
    clap,
    encodec,
    encodec_for_rate,
)
from frechet_audio_distance_exported_tpu_torch.ops import launches, window_attn  # noqa: E402
from frechet_audio_distance_exported_tpu_torch.utils import weights  # noqa: E402
from test_torch_clap_window_attn import CASES, make_inputs, operands  # noqa: E402
from test_torch_encodec_model import noise  # noqa: E402
from test_torch_pann_model import NARROW, _logmel, cnn14_tree  # noqa: E402
from test_torch_vggish_model import vggish_tree  # noqa: E402

KNOBS = ("FAD_TPU_PRECISION", "FAD_TPU_MODEL_DTYPE", "FAD_TPU_LSTM_MATMUL",
         "FAD_TPU_FUSED_BLOCK", "FAD_TPU_FUSED_ATTN")
JAX_DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
JAX_PRECISIONS = {jax.lax.Precision.HIGHEST: "highest", jax.lax.Precision.HIGH: "high",
                  jax.lax.Precision.DEFAULT: "default"}
SWIN_ULPS = 2.0
SWIN_WITHIN = 0.9
MODEL_RTOL = 2.5e-2


@pytest.fixture
def env(monkeypatch):
    """Every knob unset, TF32 flags restored after the test."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    yield monkeypatch
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        assert "FAD_TPU_" in str(e)
        return "ValueError"


def jax_resolution() -> dict:
    return {
        "precision": _outcome(lambda: JAX_PRECISIONS[jconfig.matmul_precision()]),
        "model_dtype": _outcome(lambda: JAX_DTYPES[jnp.dtype(jconfig.model_dtype())]),
        "lstm_op_dtype": _outcome(lambda: JAX_DTYPES[jnp.dtype(jconfig.lstm_op_dtype())]),
        "exactness_forced": _outcome(jconfig.exactness_forced),
        "model_dtype_is_forced": _outcome(jconfig.model_dtype_is_forced),
    }


def port_resolution() -> dict:
    return {
        "precision": _outcome(config.matmul_precision),
        "model_dtype": _outcome(config.model_dtype),
        "lstm_op_dtype": _outcome(config.lstm_op_dtype),
        "exactness_forced": _outcome(config.exactness_forced),
        "model_dtype_is_forced": _outcome(config.model_dtype_is_forced),
    }


GRID = [
    {},
    *({"FAD_TPU_PRECISION": v} for v in ("highest", "high", "default", "bfloat16", " HIGH ",
                                         "Highest", "hihg")),
    *({"FAD_TPU_MODEL_DTYPE": v} for v in ("float32", "f32", "fp32", "bfloat16", "bf16",
                                           " BF16", "fp16")),
    *({"FAD_TPU_LSTM_MATMUL": v} for v in ("float32", "f32", "fp32", "bfloat16", "bf16",
                                           "Bfloat16", "int8")),
    {"FAD_TPU_PRECISION": "highest", "FAD_TPU_MODEL_DTYPE": "float32"},
    {"FAD_TPU_PRECISION": "highest", "FAD_TPU_LSTM_MATMUL": "bfloat16"},
    {"FAD_TPU_MODEL_DTYPE": "bfloat16", "FAD_TPU_LSTM_MATMUL": "float32"},
    {"FAD_TPU_MODEL_DTYPE": "bfloat16", "FAD_TPU_LSTM_MATMUL": "bfloat16"},
    {"FAD_TPU_MODEL_DTYPE": "float32", "FAD_TPU_LSTM_MATMUL": "bf16"},
    {"FAD_TPU_MODEL_DTYPE": "fp16", "FAD_TPU_LSTM_MATMUL": "float32"},
    {"FAD_TPU_PRECISION": "high", "FAD_TPU_MODEL_DTYPE": "bfloat16"},
]


@pytest.mark.parametrize("setting", GRID, ids=lambda s: ",".join(f"{k[8:]}={v}" for k, v in
                                                                   s.items()) or "unset")
def test_knobs_resolve_as_jax_does_on_its_cpu_backend(env, setting):
    for name, value in setting.items():
        env.setenv(name, value)
    expected = jax_resolution()
    if "FAD_TPU_PRECISION" not in setting:
        # By design: JAX's unset 'high' computes exact float32 off the TPU;
        # the port names that 'highest'.
        assert expected["precision"] == "high"
        expected["precision"] = "highest"
    assert port_resolution() == expected


@pytest.mark.parametrize("value", [None, "0", "false", "off", "no", "1", "true", "on", "yes",
                                   "force", " OFF ", "True", "flase", "2"])
def test_fused_block_resolves_as_jax_does_on_a_tpu(env, value):
    """JAX picks the attention-only kernel ('fused') or the whole block
    ('fused_block') on a TPU; the port's fused_block() is True for the
    second. Typos raise in both, on any backend."""
    if value is not None:
        env.setenv("FAD_TPU_FUSED_BLOCK", value)
    env.setattr(jax, "default_backend", lambda: "tpu")
    jax_mode = _outcome(lambda: jclap._resolve_attn("auto"))
    ours = _outcome(config.fused_block)
    assert ours == (jax_mode if jax_mode == "ValueError" else jax_mode == "fused_block")


@pytest.mark.parametrize("value,tf32", [(None, False), ("highest", False), ("high", True),
                                        ("default", True), ("bfloat16", True)])
def test_apply_precision_sets_the_tf32_flags(env, value, tf32):
    if value is not None:
        env.setenv("FAD_TPU_PRECISION", value)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    assert config.apply_precision() == ("highest" if value is None else value.replace(
        "bfloat16", "default"))
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_the_calculator_applies_the_precision(env, tmp_path):
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

    env.setenv("FAD_TPU_PRECISION", "high")
    FrechetAudioDistance(model_name="pann-16k", weights="random", ckpt_dir=str(tmp_path),
                         device="cpu")
    assert torch.backends.cudnn.allow_tf32 is True
    env.delenv("FAD_TPU_PRECISION")
    FrechetAudioDistance(model_name="pann-16k", weights="random", ckpt_dir=str(tmp_path),
                         device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ---------------------------------------------------------------------------
# cast_model
# ---------------------------------------------------------------------------

def _numpy_tree(init, seed):
    """A JAX-layout tree of init's structure, drawn with numpy (no JAX compile):
    weights uniform(+-1/sqrt(fan-in)), as the JAX initialisers draw the
    convolutions and the LSTM, LayerNorm and BatchNorm gammas
    1 +- 0.1, biases and betas 0.05, BatchNorm means 0.2 and variances 0.5-1.5
    (CLAP's bn0: log-mel statistics, mean about -30 dB, variance about 100)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "gamma":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif name in ("beta", "b", "b_ih", "b_hh"):
            x = 0.05 * rng.standard_normal(v.shape)
        elif name == "mean":
            x = (-30.0 if v.shape == (64,) else 0.0) + 0.2 * rng.standard_normal(v.shape)
        elif name == "var":
            x = (100.0 if v.shape == (64,) else 1.0) * (0.5 + rng.random(v.shape))
        else:
            bound = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            x = rng.uniform(-bound, bound, v.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _tree(family):
    return {"vggish": vggish_tree, "pann": cnn14_tree,
            "clap": lambda: _numpy_tree(jclap.init_clap_params, 1),
            "encodec24": lambda: _numpy_tree(
                lambda key: jencodec.init_encodec_params(key, causal=True, channels=1), 1),
            }[family]()


# family -> (the JAX initialiser, the port module), both at full width.
INITS = {
    "vggish": (jvggish.init_vggish_params, VGGish),
    "pann": (jpann.init_pann_params, PANN),
    "clap": (jclap.init_clap_params, CLAP),
    "encodec": (lambda key: jencodec.init_encodec_params(key, causal=True, channels=1),
                lambda: encodec_for_rate(24000)),
}


@pytest.mark.parametrize("family", sorted(INITS))
def test_cast_model_keeps_what_jax_keeps_in_float32(family):
    """A JAX tree of the initialiser's structure with one-element leaves goes
    through cast_model_params; each leaf is marked 1 where it became bf16, 0
    where it stayed float32; the marks go through params_from_jax to the
    port's names, and cast_model must give those names those dtypes (on a
    module of the full widths, on the meta device)."""
    init, make = INITS[family]
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    tiny = jax.tree_util.tree_map(lambda v: jnp.zeros((1,) * len(v.shape), jnp.float32), shapes)
    cast = jpipeline.cast_model_params(family, tiny, jnp.bfloat16)
    marks = jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, float(leaf.dtype == jnp.bfloat16), np.float32), cast)
    expected = {k: bool(v.flatten()[0]) for k, v in weights.params_from_jax(marks).items()
                if v.is_floating_point()}
    with torch.device("meta"):
        model = make()
    assert pipeline.cast_model(family, model, torch.bfloat16) is model
    full = model.state_dict()
    state = {k: v for k, v in full.items() if v.is_floating_point()}
    assert set(state) == set(expected)
    assert {k: state[k].dtype == torch.bfloat16 for k in expected} == expected
    kept = {k for k, v in expected.items() if not v}
    assert kept == ({k for k in state if k.startswith(("lstm.", "conv_out."))}
                    if family == "encodec" else set())
    # Buffers outside the state_dict: CLAP's constants stay float32, the
    # gathered position bias follows the weights.
    buffers = dict(model.named_buffers())
    for name, buf in buffers.items():
        if name in full:
            continue
        if name.endswith(("interp_w", "attn_mask")):
            assert buf.dtype == torch.float32, name
        elif name.endswith("attn_bias"):
            assert buf.dtype == torch.bfloat16, name
        elif name.endswith("interp_idx"):
            assert buf.dtype == torch.int64
        else:
            raise AssertionError(f"unexpected buffer {name}")
    if family == "clap":
        assert any(n.endswith("attn_bias") for n in buffers)


def test_encodec_48k_stays_float32_unless_forced(env):
    """pipeline.model_compute_dtype against the JAX pipeline's rule
    (pipeline.py:369-385), with the platform default made bf16 in both."""
    env.setattr(config, "model_dtype", lambda: torch.bfloat16)
    env.setattr(jconfig, "model_dtype", lambda: jnp.bfloat16)
    shapes = jax.eval_shape(lambda key: jencodec.init_encodec_params(key, causal=False, channels=2),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda v: jnp.zeros((1,) * len(v.shape), jnp.float32), shapes)

    def jax_dtype(name):
        pipe = jpipeline.EmbeddingPipeline(name, params)
        return JAX_DTYPES[jnp.dtype(pipe.params["conv_in"]["w"].dtype)]

    for forced in (False, True):
        if forced:
            env.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
        assert pipeline.model_compute_dtype("encodec", 48000) == jax_dtype("encodec-48k") == (
            torch.bfloat16 if forced else torch.float32)
        assert pipeline.model_compute_dtype("encodec", 24000) == torch.bfloat16
        assert pipeline.model_compute_dtype("clap", 48000) == torch.bfloat16


# ---------------------------------------------------------------------------
# Where each torch module rounds in bf16, against models/common.py
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _jax_bf16(x):
    return jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16)


def _ulp(v):
    """The spacing of bf16 values at |v|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _module_cases():
    rng = np.random.default_rng(5)
    x4 = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)  # NHWC
    w2 = (0.2 * rng.standard_normal((3, 3, 8, 16))).astype(np.float32)  # HWIO
    b16 = (0.5 * rng.standard_normal(16)).astype(np.float32)
    x3 = rng.standard_normal((2, 50, 8)).astype(np.float32)  # NWC
    w1 = (0.3 * rng.standard_normal((3, 8, 16))).astype(np.float32)  # WIO
    wl = (0.1 * rng.standard_normal((8, 16))).astype(np.float32)
    bn = {"gamma": 1 + 0.3 * rng.standard_normal(8), "beta": 0.2 * rng.standard_normal(8),
          "mean": 0.3 * rng.standard_normal(8), "var": 0.5 + rng.random(8)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    g8, be8 = bn["gamma"], bn["beta"]

    def conv2d(x, w, b):
        m = torch.nn.Conv2d(8, 16, 3, padding=1)
        m.weight.data, m.bias.data = _bf16(w.transpose(3, 2, 0, 1)), _bf16(b)
        return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def conv1d(x, w, b):
        m = torch.nn.Conv1d(8, 16, 3)
        m.weight.data, m.bias.data = _bf16(w.transpose(2, 1, 0)), _bf16(b)
        return m(x.transpose(1, 2)).transpose(1, 2)

    def linear(x, w, b):
        m = torch.nn.Linear(8, 16)
        m.weight.data, m.bias.data = _bf16(w.T), _bf16(b)
        return m(x)

    def batch_norm(x, p):
        m = torch.nn.BatchNorm2d(8).eval()
        m.weight.data, m.bias.data = _bf16(p["gamma"]), _bf16(p["beta"])
        m.running_mean, m.running_var = _bf16(p["mean"]), _bf16(p["var"])
        return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def group_norm(x, g, b):
        m = torch.nn.GroupNorm(1, 8, eps=1e-5)
        m.weight.data, m.bias.data = _bf16(g), _bf16(b)
        return m(x.transpose(1, 2)).transpose(1, 2)

    def clap_layer_norm(x, g, b):
        return clap.layer_norm(x, _bf16(g), _bf16(b))

    def clap_dense(x, w, b):
        m = clap.Dense(8, 16)
        m.w.data, m.b.data = _bf16(w), _bf16(b)
        return m(x)

    # name -> (torch fn of bf16 x, JAX fn of bf16 x, x, the rest of the arguments)
    return {
        "conv2d": (conv2d, lambda x: jcommon.conv2d(x, _jax_bf16(w2), _jax_bf16(b16)), x4,
                   (w2, b16)),
        "conv1d": (conv1d, lambda x: jcommon.conv1d(x, _jax_bf16(w1), _jax_bf16(b16)), x3,
                   (w1, b16)),
        "linear": (linear, lambda x: jcommon.linear(x, _jax_bf16(wl), _jax_bf16(b16)), x3,
                   (wl, b16)),
        "clap_dense": (clap_dense, lambda x: jcommon.linear(x, _jax_bf16(wl), _jax_bf16(b16)),
                       x3, (wl, b16)),
        "batch_norm": (batch_norm, lambda x: jcommon.batch_norm(
            x, {k: _jax_bf16(v) for k, v in bn.items()}), x4, (bn,)),
        "group_norm": (group_norm, lambda x: jcommon.group_norm_full(
            x, _jax_bf16(g8), _jax_bf16(be8)), x3 * 3 + 1, (g8, be8)),
        "clap_layer_norm": (clap_layer_norm, lambda x: jcommon.layer_norm(
            x, _jax_bf16(g8), _jax_bf16(be8)), x3 * 3 + 1, (g8, be8)),
    }


# name -> (most bf16 ulps of the output's largest magnitude, least share equal)
MODULE_BOUNDS = {
    "conv2d": (1.0, 0.5), "conv1d": (1.0, 0.5), "linear": (1.0, 0.5), "clap_dense": (0.0, 1.0),
    "batch_norm": (1.0, 0.4), "group_norm": (0.0, 1.0), "clap_layer_norm": (0.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(MODULE_BOUNDS))
def test_bf16_modules_round_where_the_jax_helpers_do(name):
    """bf16 in, bf16 out, float32 inside. The norms take float32 moments and
    round once, as JAX does (GroupNorm, the port's CLAP LayerNorm: equal),
    or within an ulp (BatchNorm: JAX forms scale and shift in bf16). The
    CLAP Dense adds its bias after the product's rounding, as JAX does;
    nn.Conv and nn.Linear add it before: within one ulp, and the product
    alone is JAX's bit for bit (below)."""
    ours_fn, jax_fn, x, _ = _module_cases()[name]
    with torch.inference_mode():
        ours = ours_fn(_bf16(x), *_module_cases()[name][3])
    ref = jax_fn(_jax_bf16(x))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    ulps, equal = MODULE_BOUNDS[name]
    diff = np.abs(ours - ref)
    assert diff.max() <= ulps * _ulp(np.abs(ref).max())
    assert (diff == 0).mean() >= equal


def test_convolution_product_alone_is_jax_conv():
    """Without its bias, the bf16 convolution is JAX's conv2d(...) before the
    bias add, float32 sums rounded once to bf16: equal but where the two sum
    orders fall on two sides of a rounding boundary (1 of 3840 here), and
    there one ulp apart."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 16))).astype(np.float32)
    ref = np.asarray(jcommon.conv2d(_jax_bf16(x), _jax_bf16(w)).astype(jnp.float32))
    ours = torch.nn.functional.conv2d(_bf16(x).permute(0, 3, 1, 2),
                                      _bf16(w.transpose(3, 2, 0, 1)), padding=1)
    diff = np.abs(ours.permute(0, 2, 3, 1).float().numpy() - ref)
    assert (diff == 0).mean() >= 0.999
    assert (diff <= _ulp(ref)).all()


# ---------------------------------------------------------------------------
# The plain bf16 Swin versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _bf16_operands(args):
    return {k: v if k == "mask" else v.to(torch.bfloat16) for k, v in args.items()}


@pytest.mark.parametrize("case", ["block_stage1_shifted", "block_stage3_shifted",
                                  "attention_stage4"])
def test_plain_bf16_versions_match_jax_pallas_interpret(case):
    kernel, c, heads, nw, shifted, batch = CASES[case]
    args = _bf16_operands(operands(kernel, make_inputs(c, heads, nw, shifted, batch)))
    jargs = [jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if k in ("mask", "bias") else jnp.bfloat16) for k, v in args.items()]
    ref = getattr(jkernels, kernel)(*jargs, heads=heads, num_windows=nw, interpret=True)
    assert ref.dtype == jnp.bfloat16
    before = launches.read()
    ours = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    assert launches.read() == before  # a CPU tensor takes the plain version
    assert ours.dtype == torch.bfloat16 and ours.shape == (batch * nw, 64, c)
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    diff = np.abs(ours - ref)
    assert diff.max() <= SWIN_ULPS * _ulp(np.abs(ref).max())
    assert (diff <= _ulp(ref)).mean() >= SWIN_WITHIN
    # The bf16 result is not the float32 one rounded: the rounding points show.
    f32 = getattr(window_attn, kernel)(**operands(kernel, make_inputs(c, heads, nw, shifted,
                                                                       batch)),
                                       heads=heads, num_windows=nw).numpy()
    assert np.abs(f32 - ref).max() > diff.max()


def test_plain_bf16_rounds_at_the_pallas_points():
    """The attention residual of swin_block_fused's plain version, rebuilt
    from its own rounding points, is what window_attention_fused's plain
    version returns; and x2 (rounded) is what LN2 reads."""
    kernel, c, heads, nw, shifted, batch = CASES["block_stage1"]
    args = _bf16_operands(operands(kernel, make_inputs(c, heads, nw, shifted, batch)))
    attention = {k: args[k] for k in ("x_windows", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias",
                                      "mask", "gamma1", "beta1")}
    x2 = window_attn.window_attention_fused(**attention, heads=heads, num_windows=nw)
    f = {k: v.float() for k, v in args.items()}
    h2 = window_attn._layer_norm(x2.float(), f["gamma2"], f["beta2"]).to(torch.bfloat16).float()
    hidden = torch.nn.functional.gelu(h2 @ f["w_fc1"] + f["b_fc1"]).to(torch.bfloat16).float()
    out = (x2.float() + (hidden @ f["w_fc2"] + f["b_fc2"])).to(torch.bfloat16)
    assert torch.equal(window_attn.swin_block_fused(**args, heads=heads, num_windows=nw), out)


def test_wrappers_take_one_dtype_and_a_float32_mask():
    kernel, c, heads, nw, shifted, batch = CASES["block_stage1"]
    args = operands(kernel, make_inputs(c, heads, nw, shifted, batch))
    bf = _bf16_operands(args)
    fused = window_attn.swin_block_fused
    fused(**bf, heads=heads, num_windows=nw)
    with pytest.raises(TypeError, match="mask"):
        fused(**{**bf, "mask": bf["mask"].to(torch.bfloat16)}, heads=heads, num_windows=nw)
    with pytest.raises(TypeError, match="w_fc1"):
        fused(**{**bf, "w_fc1": args["w_fc1"]}, heads=heads, num_windows=nw)
    with pytest.raises(TypeError, match="bias"):
        fused(**{**args, "bias": bf["bias"]}, heads=heads, num_windows=nw)
    with pytest.raises(TypeError, match="float16"):
        fused(**{k: v if k == "mask" else v.half() for k, v in args.items()}, heads=heads,
              num_windows=nw)
    scratch = window_attn.attention_scratch(2, 96, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in scratch.values())
    window_attn._check_scratch(scratch, 2, 96, "cpu", torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        window_attn._check_scratch(window_attn.attention_scratch(2, 96, "cpu"), 2, 96, "cpu",
                                   torch.bfloat16)


# ---------------------------------------------------------------------------
# Whole models in bf16 against the JAX package's bf16 path
# ---------------------------------------------------------------------------

def _port_bf16(family, model, x):
    pipeline.cast_model(family, model, torch.bfloat16)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        out = model(xt if family == "encodec" else xt.to(torch.bfloat16))
    return out.float().numpy()


def _jax_bf16_forward(family, forward, tree, x):
    """The JAX pipeline's bf16_forward (pipeline.py:389-397)."""
    params = jpipeline.cast_model_params(family, jax.tree_util.tree_map(jnp.asarray, tree),
                                         jnp.bfloat16)
    xj = jnp.asarray(x)
    if family != "encodec":
        xj = xj.astype(jnp.bfloat16)
    return np.asarray(forward(params, xj).astype(jnp.float32))


def _models():
    return {
        "vggish": (lambda: _tree("vggish"), VGGish, jvggish.vggish_forward,
                   lambda: (np.random.default_rng(1).standard_normal((4, 96, 64)) * 2.0
                            - 3.0).astype(np.float32)),
        "pann": (lambda: _tree("pann"), lambda: PANN(NARROW), jpann.pann_forward,
                 lambda: _logmel(3, 232, [232, 200, 100], seed=2)),
        "clap": (lambda: _tree("clap"), CLAP, lambda p, x: jclap.clap_forward(p, x, attn="xla"),
                 lambda: (np.random.default_rng(1).standard_normal((2, 1001, 64)) * 10.0
                          - 30.0).astype(np.float32)),
        "encodec": (lambda: _tree("encodec24"), lambda: encodec_for_rate(24000),
                    lambda p, x: jencodec.encodec_forward(p, x, causal=True),
                    lambda: noise((2, 1, 32000), 5)),
    }


@pytest.mark.parametrize("family", ["vggish", "pann", "clap", "encodec"])
def test_bf16_model_matches_jax_bf16_path(env, family):
    """The float32 reference is the port's own float32 forward, which the
    model tests hold to JAX's within 1e-4 (one XLA compile fewer)."""
    make_tree, make_model, forward, make_x = _models()[family]
    tree, x = make_tree(), make_x()
    ref = _jax_bf16_forward(family, forward, tree, x)
    model = make_model()
    model.load_state_dict(weights.params_from_jax(tree))
    model.eval()
    with torch.inference_mode():
        ref32 = model(torch.from_numpy(x)).numpy()
    ours = _port_bf16(family, model, x)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    scale = np.abs(ref32).max()
    err = np.abs(ours - ref).max()
    assert err <= MODEL_RTOL * scale
    assert err <= 2 * np.abs(ref - ref32).max()  # no more than bf16's own noise
    assert np.abs(ours - ref32).max() > 0  # the model really ran in bf16


def test_bf16_fad_matches_jax_between_packages(env, tmp_path):
    """VGGish in bf16 mode in both packages, on one JAX-written bundle and the
    same 16 + 16 clips: the FAD within 1e-3 absolute (the repository's bar;
    random-weight VGGish scores some 4e-4, so it is loose here), and within
    twice the JAX package's own bf16-vs-float32 delta relative: the two
    packages differ by bf16 rounding noise, not more (measured: 4.8e-4
    relative between them, 1.5e-3 in JAX between its two modes)."""
    from frechet_audio_distance_exported_tpu import FrechetAudioDistance as JaxFAD
    from frechet_audio_distance_exported_tpu.utils.weights import save_weights
    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance

    save_weights(str(tmp_path / "vggish_tpu.npz"), vggish_tree(3))
    rng = np.random.default_rng(7)
    t = np.arange(32000) / 16000
    bg = [(0.5 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32) for i in range(16)]
    ev = [(0.1 * rng.standard_normal(t.size)).astype(np.float32) for _ in range(16)]

    def score(cls, **kwargs):
        fad = cls(model_name="vggish", weights="auto", ckpt_dir=str(tmp_path), **kwargs)
        stats = [fad.calculate_embd_statistics(fad.get_embeddings(c, 16000)) for c in (bg, ev)]
        return float(fad.calculate_frechet_distance(*stats[0], *stats[1]))

    jax_f32 = score(JaxFAD)
    env.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    jax_bf16, ours = score(JaxFAD), score(FrechetAudioDistance, device="cpu")
    assert ours > 1e-4
    assert abs(ours - jax_bf16) <= 1e-3
    assert abs(ours - jax_bf16) <= 2 * abs(jax_bf16 - jax_f32)


def test_bf16_lstm_operands_match_jax_slstm(env):
    tree = _tree("encodec24")
    model = encodec_for_rate(24000)
    model.load_state_dict(weights.params_from_jax(tree))
    x = noise((3, 150, encodec.HIDDEN), 9, 1.0)
    ref = np.asarray(jencodec._slstm(tree["lstm"], jnp.asarray(x), op_dtype=jnp.bfloat16))
    ref32 = np.asarray(jencodec._slstm(tree["lstm"], jnp.asarray(x), op_dtype=jnp.float32))
    env.setenv("FAD_TPU_LSTM_MATMUL", "bfloat16")
    with torch.inference_mode():
        ours = model.lstm(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert np.abs(ours - ref32).max() > 1e-4  # the operands really were rounded


def test_fused_block_0_routes_every_stage_through_the_attention_kernel(env):
    """Spies on the window kernels: the default runs swin_block_fused for the
    10 blocks of stages 1-3 and window_attention_fused for stage 4's 2;
    FAD_TPU_FUSED_BLOCK=0 runs window_attention_fused for all 12 and their
    MLPs in torch, with the same embedding (float32, 1e-5)."""
    model = CLAP()
    model.load_state_dict(weights.init_random_params("clap", 0))
    model.eval()
    calls = {}
    for name in ("swin_block_fused", "window_attention_fused"):
        inner = getattr(clap, name)

        def spy(*args, _name=name, _inner=inner, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*args, **kwargs)

        env.setattr(clap, name, spy)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 1001, 64)).astype(
        np.float32) * 10.0 - 30.0)
    outputs = {}
    for value in (None, "0"):
        if value is not None:
            env.setenv("FAD_TPU_FUSED_BLOCK", value)
        calls.clear()
        with torch.inference_mode():
            outputs[value] = model(x)
        expected = ({"swin_block_fused": 10, "window_attention_fused": 2} if value is None
                    else {"window_attention_fused": 12})
        assert calls == expected
    np.testing.assert_allclose(outputs["0"].numpy(), outputs[None].numpy(), rtol=0, atol=1e-5)
    env.setenv("FAD_TPU_FUSED_BLOCK", "flase")
    with pytest.raises(ValueError, match="FAD_TPU_FUSED_BLOCK"):
        model(x)


def test_sharded_path_runs_the_same_bf16_model(env, tmp_path):
    """Under a mesh (one gloo rank here) the calculator embeds through the same
    cast model and forward as without one: the same bf16 rows."""
    import socket

    import torch.distributed as dist

    from frechet_audio_distance_exported_tpu_torch import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu_torch.parallel import mesh as mesh_mod

    env.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    clips = [noise((20000,), seed, 0.3) for seed in range(3)]
    kwargs = dict(model_name="vggish", weights="random", ckpt_dir=str(tmp_path), device="cpu")
    alone = FrechetAudioDistance(**kwargs)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh_mod.initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        sharded = FrechetAudioDistance(**kwargs, mesh=mesh_mod.data_mesh(device="cpu"))
        assert sharded.pipeline.dtype == alone.pipeline.dtype == torch.bfloat16
        rows = sharded.get_embeddings(clips, 16000)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(rows, alone.get_embeddings(clips, 16000))
    assert rows.dtype == np.float32 and rows.shape == (3, 128)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """Decided per test, not at import: every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_kernel_matches_plain_version_on_the_card(cuda_device, case):
    kernel, c, heads, nw, shifted, batch = CASES[case]
    args = _bf16_operands(operands(kernel, make_inputs(c, heads, nw, shifted, batch, seed=1),
                                   cuda_device))
    key = f"{kernel}[bf16]"
    before = launches.read()[key]
    out = getattr(window_attn, kernel)(**args, heads=heads, num_windows=nw)
    torch.cuda.synchronize()
    assert launches.read()[key] == before + 1
    ref = getattr(window_attn, f"{kernel}_reference")(**args, heads=heads, num_windows=nw)
    assert out.dtype == ref.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    diff = np.abs(out - ref)
    assert diff.max() <= SWIN_ULPS * _ulp(np.abs(ref).max())
    assert (diff <= _ulp(ref)).mean() >= SWIN_WITHIN


@pytest.mark.cuda
def test_graphed_bf16_lstm_equals_the_eager_steps_on_the_card(cuda_device, env):
    model = encodec_for_rate(24000)
    model.load_state_dict(weights.init_random_params("encodec-24k", 0))
    lstm = model.lstm.to(cuda_device)
    env.setenv("FAD_TPU_LSTM_MATMUL", "bfloat16")
    for seed in (0, 1):  # the second replays the first's graph on new inputs
        seq = torch.randn((4, 40, encodec.HIDDEN), generator=torch.Generator().manual_seed(seed))
        seq = seq.to(cuda_device)
        with torch.inference_mode():
            graphed = lstm.forward_bf16_operands(seq)
            eager = encodec.recurrence_bf16_operands(*lstm.bf16_operands(seq))
        torch.cuda.synchronize()
        assert torch.equal(graphed, eager)
    assert len(lstm._graphs) == 1
