"""Parity of the PyTorch ResNet-V2 port (vtpu_torch/models) with the flax
reference (vtpu/models) on the CPU, at small sizes.

Inputs and BatchNorm statistics are drawn from a numpy seed, the flax
weights are carried across with ``from_flax``, and both frameworks run the
same function. Tolerances:

- float32: ``max|Δ| <= 1e-4 * max|ref| + 1e-5`` (two CPU convolution
  libraries sum in different orders; nothing else differs);
- bfloat16 compute: relative L2 error ``<= 5e-2`` (bf16 keeps 8 bits of
  mantissa and the two frameworks round at different points inside their
  convolutions).
"""

import functools
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import BENCH_CASES as JAX_CASES
from vtpu.models.registry import MODELS as JAX_MODELS
from vtpu.models.resnet import BottleneckV2 as JaxBottleneck
from vtpu.models.resnet import ResNetV2 as JaxResNetV2
from vtpu.models.resnet import resnet_stem as jax_resnet_stem
from vtpu.models.resnet import resnet_v2_50 as jax_resnet_v2_50
from vtpu.models.train import cross_entropy as jax_cross_entropy
from vtpu.models.train import make_infer_step as jax_make_infer_step
from vtpu_torch.models import BENCH_CASES, MODELS, get_model
from vtpu_torch.models.convert import from_flax
from vtpu_torch.models.norm import BatchNorm
from vtpu_torch.models.resnet import (
    BottleneckV2,
    ResNetV2,
    resnet_stem,
    resnet_v2_50,
    stem_conv,
)
from vtpu_torch.models.train import cross_entropy, init_model, make_infer_step

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_close(got, ref, kind):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    if kind == "f32":
        err = np.abs(got - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-5, err
    else:
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 5e-2, rel


def randomize_stats(params, batch_stats, rng):
    """BatchNorm scale/bias and running stats away from their identity
    init, so the tests see the normalisation arithmetic."""
    def leaf(path, v):
        name = path[-1].key
        v = np.asarray(v)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        if name == "mean":
            return rng.normal(0.0, 0.5, v.shape).astype(v.dtype)
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
        if name == "bias" and v.ndim == 1:
            return rng.normal(0.0, 0.1, v.shape).astype(v.dtype)
        return v
    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, batch_stats))


@functools.lru_cache(maxsize=None)
def flax_variables(make_module, shape, seed=0):
    """Initialise the float32 flax module ``make_module(jnp.float32)`` on
    an input of ``shape`` and randomize its BN state; (params,
    batch_stats). flax keeps parameters in float32 whatever the compute
    dtype, so one init serves both dtypes (and keeps JAX's CPU compile
    time down)."""
    x = jnp.zeros(shape, jnp.float32)
    variables = jax.jit(make_module(jnp.float32).init)(
        jax.random.PRNGKey(seed), x)
    return randomize_stats(variables["params"],
                           variables.get("batch_stats", {}),
                           np.random.default_rng(seed))


def flax_run(make_module, x, jdt, seed=0):
    """Apply ``make_module(jdt)`` in inference mode to ``x`` (cast to
    ``jdt``); returns (numpy float32 output, params, batch_stats)."""
    params, stats = flax_variables(make_module, x.shape, seed)
    out = jax.jit(make_module(jdt).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x, jdt))
    return np.asarray(out.astype(jnp.float32)), params, stats


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


JAX_NORM = partial(fnn.BatchNorm, use_running_average=True, momentum=0.9,
                   epsilon=1e-5)

# (in_features, filters, strides, rate, spatial): identity shortcut,
# projection, stride 2, an odd size as case 1.1 has (87 -> 44), atrous
BLOCKS = {
    "identity": (16, 4, 1, 1, 9),
    "projection": (8, 4, 1, 1, 9),
    "stride2": (16, 4, 2, 1, 10),
    "stride2_odd87": (8, 2, 2, 1, 87),
    "rate2": (16, 4, 1, 2, 9),
}


@functools.lru_cache(maxsize=None)
def _flax_block(block):
    _, filters, strides, rate, _ = BLOCKS[block]
    return lambda dtype: JaxBottleneck(filters=filters, strides=strides,
                                       rate=rate, dtype=dtype, norm=JAX_NORM)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bottleneck_matches_flax(block, kind):
    cin, filters, strides, rate, hw = BLOCKS[block]
    jdt, tdt = DTYPES[kind]
    x = np.random.default_rng(1).normal(size=(2, hw, hw, cin)).astype(
        np.float32)
    ref, params, stats = flax_run(_flax_block(block), x, jdt)
    block_t = BottleneckV2(cin, filters, strides=strides, rate=rate,
                           dtype=tdt)
    block_t.load_state_dict(from_flax(params, stats))
    assert block_t.needs_proj == ("proj" in params)
    with torch.no_grad():
        out = block_t.eval()(nchw(x).to(tdt))
    assert out.dtype == tdt
    assert out.shape[2] == -(-hw // strides)
    assert_close(nhwc(out), ref, kind)


class _FlaxStem(fnn.Module):
    width: int
    dtype: object

    @fnn.compact
    def __call__(self, x):
        return jax_resnet_stem(x, self.width, self.dtype)


def _flax_stem(dtype):
    return _FlaxStem(8, dtype)


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_stem_matches_flax_at_odd_size(kind):
    jdt, tdt = DTYPES[kind]
    x = np.random.default_rng(2).normal(size=(2, 35, 35, 3)).astype(
        np.float32)
    ref, params, stats = flax_run(_flax_stem, x, jdt)
    holder = torch.nn.Module()
    holder.conv_root = stem_conv(3, 8, tdt)
    holder.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        out = resnet_stem(nchw(x).to(tdt), holder.conv_root)
    assert out.shape == (2, 8, 9, 9)
    assert_close(nhwc(out), ref, kind)


def _flax_narrow(dtype):
    return JaxResNetV2(stage_sizes=(1, 1, 1, 1), width=8, dtype=dtype)


def _flax_resnet_v2_50(dtype):
    return jax_resnet_v2_50(dtype=dtype)


WHOLE = {
    "narrow": (_flax_narrow, lambda dtype: ResNetV2(
        stage_sizes=(1, 1, 1, 1), width=8, dtype=dtype)),
    "resnet_v2_50": (_flax_resnet_v2_50,
                     lambda dtype: resnet_v2_50(dtype=dtype)),
}


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_model_matches_flax(name, kind):
    jdt, tdt = DTYPES[kind]
    make_flax, make_port = WHOLE[name]
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    params, stats = flax_variables(make_flax, x.shape)
    ref = np.asarray(jax.jit(jax_make_infer_step(make_flax(jdt)))(
        params, stats, jnp.asarray(x)))
    model = make_port(tdt)
    model.load_state_dict(from_flax(params, stats))
    out = make_infer_step(model)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 1000)
    assert_close(out.numpy(), ref, kind)


def test_init_model_draws_flax_distributions():
    """lecun_normal kernels (truncated at 2 std, variance 1/fan_in), zero
    Dense bias, identity BatchNorm, as flax's default initializers; and
    the same seed gives the same weights."""
    model = ResNetV2(stage_sizes=(1, 1, 1, 1), width=8,
                     dtype=torch.float32)
    x = torch.zeros(1, 16, 16, 3)
    init_model(model, x, torch.Generator().manual_seed(5))
    variables = jax.jit(_flax_narrow(jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    ref = from_flax(variables["params"], variables["batch_stats"])
    state = model.state_dict()
    assert set(state) == set(ref)
    for key, t in state.items():
        assert t.shape == ref[key].shape, key
        if key.endswith("conv3.weight") or key == "head.weight":
            fan_in = t[0].numel()
            std = float(t.std())
            assert abs(std - fan_in ** -0.5) < 0.2 * fan_in ** -0.5, key
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(t.abs().max()) <= bound + 1e-6, key
            assert float(ref[key].abs().max()) <= bound + 1e-6, key
        elif not key.endswith("weight") or "bn" in key:
            torch.testing.assert_close(t, ref[key], rtol=0, atol=0)
    again = ResNetV2(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32)
    init_model(again, x, torch.Generator().manual_seed(5))
    for key, t in again.state_dict().items():
        assert torch.equal(t, state[key]), key


def test_batchnorm_training_update_matches_flax():
    """Training mode: batch statistics, flax momentum (0.9), and the
    BIASED batch variance in the running update."""
    rng = np.random.default_rng(6)
    x = rng.normal(1.0, 2.0, size=(4, 5, 5, 6)).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    variables = jax.jit(jbn.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = randomize_stats(variables["params"],
                                    variables["batch_stats"], rng)
    ref, updates = jbn.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6, dtype=torch.float32)
    bn.load_state_dict(from_flax(params, stats))
    out = bn.train()(nchw(x))
    assert_close(nhwc(out.detach()), np.asarray(ref), "f32")
    new = updates["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5, atol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=(6,))
    ref = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_registry_mirrors_reference_matrix():
    assert [(c.case, c.model, c.mode, c.batch, c.shape, c.classes)
            for c in BENCH_CASES] == [
        (c.case, c.model, c.mode, c.batch, c.shape, c.classes)
        for c in JAX_CASES]
    # every model of the reference's registry is ported (VGG-16, DeepLab-v3
    # and the LSTM are held to flax in tests/test_torch_zoo.py)
    assert sorted(MODELS) == sorted(JAX_MODELS)
    model = get_model("resnet_v2_152", num_classes=3)
    assert len(model.block_names) == 3 + 8 + 36 + 3
    assert model.head.out_features == 3
