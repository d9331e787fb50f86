"""Parity of the port's VGG-16, DeepLab-v3 and stacked LSTM
(vtpu_torch/models/{vgg,deeplab,lstm}.py) with the flax reference
(vtpu/models/{vgg,deeplab,lstm}.py) on the CPU, at small sizes.

Inputs come from a numpy seed, the flax weights (biases and BatchNorm
state randomized away from their init) are carried across with
``from_flax``, and both frameworks run the same function. Sizes: VGG at
32x32 (1x1 after its five pools) with a narrow ``cfg`` and ``fc1``/``fc2``
4096 wide, as the reference fixes them; DeepLab at ``width=8``,
``backbone_stages=(1, 1, 1, 1)``, 64x64 for inference and 48x48 (and
batch 1, as case 4.2) for training; the LSTM at ``hidden=20`` (padded to
128), 16 steps of 12 features.

Tolerances are those of tests/test_torch_models.py: float32 logits and
losses ``max|Δ| <= 1e-4 * max|ref| + 1e-5``; bfloat16 compute, relative
L2 ``<= 5e-2``. One float32 SGD step's parameter update is held within
relative L2 1e-3 of the reference's. torch cannot replay flax's dropout
RNG, so VGG's step runs with dropout off on both sides (the reference
through a subclass whose ``train`` never reaches its dropout, the port with
its rate patched to 0 for the test), and the port's dropout is checked on
its own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import assert_close, randomize_stats
from vtpu.models.deeplab import DeepLabV3 as JaxDeepLabV3
from vtpu.models.lstm import StackedLSTM as JaxStackedLSTM
from vtpu.models.registry import MODELS as JAX_MODELS
from vtpu.models.train import make_train_step as jax_make_train_step
from vtpu.models.vgg import VGG16 as JaxVGG16
from vtpu_torch.models import BENCH_CASES, MODELS, case_model
from vtpu_torch.models import vgg as port_vgg_module
from vtpu_torch.models.convert import from_flax
from vtpu_torch.models.deeplab import DeepLabV3
from vtpu_torch.models.lstm import StackedLSTM
from vtpu_torch.models.train import make_infer_step, make_train_step
from vtpu_torch.models.vgg import VGG16, dropout

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
UPDATE_REL = 1e-3

VGG_CFG = (8, 8, "M", 16, 16, "M", 16, 16, 16, "M", 16, 16, 16, "M",
           16, 16, 16, "M")
VGG_CLASSES = 10
DEEPLAB_CLASSES = 5
LSTM_HIDDEN, LSTM_T, LSTM_F, LSTM_CLASSES = 20, 16, 12, 10


class _JaxVGGNoDropout(JaxVGG16):
    """The reference VGG with its dropout off in training (it has no other
    train-only behaviour): the same module tree and parameters."""

    def __call__(self, x, train: bool = False):
        return super().__call__(x, train=False)


def _vgg(jdt):
    return JaxVGG16(num_classes=VGG_CLASSES, dtype=jdt, cfg=VGG_CFG)


def _vgg_no_dropout(jdt):
    return _JaxVGGNoDropout(num_classes=VGG_CLASSES, dtype=jdt, cfg=VGG_CFG)


def _deeplab(jdt):
    return JaxDeepLabV3(num_classes=DEEPLAB_CLASSES, dtype=jdt, width=8,
                        backbone_stages=(1, 1, 1, 1))


def _lstm(jdt):
    return JaxStackedLSTM(hidden=LSTM_HIDDEN, num_classes=LSTM_CLASSES,
                          dtype=jdt)


def port_vgg(tdt):
    return VGG16(num_classes=VGG_CLASSES, dtype=tdt, cfg=VGG_CFG,
                 input_size=32)


def port_deeplab(tdt):
    return DeepLabV3(num_classes=DEEPLAB_CLASSES, dtype=tdt, width=8,
                     backbone_stages=(1, 1, 1, 1))


def port_lstm(tdt):
    return StackedLSTM(LSTM_F, hidden=LSTM_HIDDEN, num_classes=LSTM_CLASSES,
                       dtype=tdt)


# name -> (flax module of a dtype, port module of a dtype, input shape,
# training input shape, classes, whether the labels are per pixel)
ZOO = {
    "vgg16": (_vgg, port_vgg, (2, 32, 32, 3), (2, 32, 32, 3), VGG_CLASSES,
              False),
    "deeplab_v3": (_deeplab, port_deeplab, (2, 64, 64, 3), (2, 48, 48, 3),
                   DEEPLAB_CLASSES, True),
    "lstm": (_lstm, port_lstm, (3, LSTM_T, LSTM_F), (3, LSTM_T, LSTM_F),
             LSTM_CLASSES, False),
}


@functools.lru_cache(maxsize=None)
def variables(name, shape, seed=0):
    """float32 flax variables of ``name`` initialised on ``shape``, biases
    and BatchNorm state randomized: (params, batch_stats)."""
    make_flax = ZOO[name][0]
    v = jax.jit(make_flax(jnp.float32).init)(jax.random.PRNGKey(seed),
                                             jnp.zeros(shape, jnp.float32))
    return randomize_stats(v["params"], v.get("batch_stats", {}),
                           np.random.default_rng(seed))


def port_model(name, tdt, shape):
    model = ZOO[name][1](tdt)
    params, stats = variables(name, shape)
    model.load_state_dict(from_flax(params, stats))
    return model


def batch(shape, classes, per_pixel, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    labels = shape[:3] if per_pixel else shape[:1]
    return x, rng.integers(0, classes, size=labels).astype(np.int32)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(ZOO))
def test_inference_matches_flax(name, kind):
    """Logits of one inference step, the port's make_infer_step against
    the flax model's apply with ``train=False``."""
    make_flax, _, shape, _, classes, per_pixel = ZOO[name]
    jdt, tdt = DTYPES[kind]
    params, stats = variables(name, shape)
    x, _ = batch(shape, classes, per_pixel, 1)
    flax_vars = {"params": params}
    if stats:
        flax_vars["batch_stats"] = stats
    ref = jax.jit(functools.partial(make_flax(jdt).apply, train=False))(
        flax_vars, jnp.asarray(x))
    out = make_infer_step(port_model(name, tdt, shape))(torch.from_numpy(x))
    assert out.dtype == torch.float32
    want = shape[:3] + (classes,) if per_pixel else (shape[0], classes)
    assert tuple(out.shape) == want == ref.shape
    assert_close(out.numpy(), np.asarray(ref, np.float32), kind)


def one_reference_step(name, x, y, make_flax):
    params, stats = variables(name, x.shape)
    jstep, tx = jax_make_train_step(make_flax(jnp.float32),
                                    has_batch_stats=bool(stats))
    new_params, _, new_stats, loss = jax.jit(jstep)(
        params, tx.init(params), stats, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(3))
    return (float(loss), from_flax(params, stats),
            from_flax(new_params, new_stats))


def flat_update(before, after):
    names = sorted(n for n in after if "running" not in n)
    return np.concatenate([np.asarray(after[n], np.float64).ravel()
                           - np.asarray(before[n], np.float64).ravel()
                           for n in names])


TRAIN = {name: spec[3] for name, spec in ZOO.items()}
TRAIN["deeplab_v3_batch1"] = (1, 48, 48, 3)


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_f32_train_step_matches_flax(case, monkeypatch):
    """One float32 SGD step from the same weights and batch: the loss to
    the float32 tolerance, the whole parameter update within relative L2
    1e-3 and the running statistics to the float32 tolerance. VGG's step
    has dropout off on both sides; DeepLab also steps at batch 1, where
    the image-pool branch's BatchNorm sees one value per channel."""
    name = case.replace("_batch1", "")
    make_flax, _, _, _, classes, per_pixel = ZOO[name]
    shape = TRAIN[case]
    if name == "vgg16":
        make_flax = _vgg_no_dropout
        monkeypatch.setattr(port_vgg_module, "DROPOUT", 0.0)
    x, y = batch(shape, classes, per_pixel, 2)
    ref_loss, before, ref_after = one_reference_step(name, x, y, make_flax)
    model = ZOO[name][1](torch.float32)
    model.load_state_dict(before)
    step, _ = make_train_step(model)
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(loss)
    assert_close(loss, ref_loss, "f32")
    after = {n: t.detach() for n, t in model.state_dict().items()}
    assert set(after) == set(ref_after)
    got, ref = flat_update(before, after), flat_update(before, ref_after)
    assert np.linalg.norm(ref) > 0
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= UPDATE_REL, rel
    for n in after:
        if "running" in n:
            assert_close(after[n], ref_after[n], "f32")


@pytest.mark.parametrize("name", sorted(ZOO))
def test_from_flax_covers_every_leaf(name):
    """Every flax leaf (params and batch_stats) lands on exactly one port
    tensor of the same size, and no port tensor is left without one."""
    _, make_port, shape, *_ = ZOO[name]
    params, stats = variables(name, shape)
    leaves = jax.tree_util.tree_leaves((params, stats))
    converted = from_flax(params, stats)
    model = make_port(torch.float32)
    state = model.state_dict()
    assert len(converted) == len(leaves)
    assert set(converted) == set(state)
    for key, t in converted.items():
        assert t.shape == state[key].shape, key
    assert sum(int(np.prod(np.shape(v))) for v in leaves) == sum(
        t.numel() for t in state.values())


def test_vgg_fc1_reads_features_in_nhwc_order():
    """At 64x64 VGG's last map is 2x2, so fc1's rows mix space and
    channels: the port's logits match flax's only if it flattens in
    flax's (h, w, c) order."""
    shape = (2, 64, 64, 3)
    jax_model = _vgg(jnp.float32)
    v = jax.jit(jax_model.init)(jax.random.PRNGKey(5),
                                jnp.zeros(shape, jnp.float32))
    x, _ = batch(shape, VGG_CLASSES, False, 6)
    ref = jax_model.apply(v, jnp.asarray(x))
    model = VGG16(num_classes=VGG_CLASSES, dtype=torch.float32,
                  cfg=VGG_CFG, input_size=64)
    assert model.fc1.in_features == 2 * 2 * 16
    model.load_state_dict(from_flax(v["params"], {}))
    out = make_infer_step(model)(torch.from_numpy(x))
    assert_close(out.numpy(), np.asarray(ref), "f32")


def test_vgg_dropout_keeps_half_and_scales_by_two():
    """The port's dropout at rate 0.5 over 10^5 units: a keep share of
    0.5 +- 0.02, every survivor scaled by 2, the mask a function of the
    generator's seed; off in eval mode and at rate 0."""
    x = torch.rand(100_000) + 0.5
    out = dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.5) <= 0.02
    torch.testing.assert_close(out[kept], 2 * x[kept], rtol=0, atol=0)
    again = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    other = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    assert dropout(x, 0.0, None) is x
    model = VGG16(num_classes=VGG_CLASSES, dtype=torch.float32,
                  cfg=VGG_CFG, input_size=32)
    xb = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(xb), model(xb))
        model.train()
        a = model(xb, generator=torch.Generator().manual_seed(2))
        b = model(xb, generator=torch.Generator().manual_seed(2))
        c = model(xb, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_step_draws_vgg_dropout_from_its_generator():
    """make_train_step hands its generator to VGG's dropout: two steps
    from one state with one seed give one loss, another seed another."""
    x, y = batch((2, 32, 32, 3), VGG_CLASSES, False, 7)
    losses = []
    for seed in (4, 4, 5):
        model = VGG16(num_classes=VGG_CLASSES, dtype=torch.float32,
                      cfg=VGG_CFG, input_size=32)
        model.load_state_dict(port_model("vgg16", torch.float32,
                                         (2, 32, 32, 3)).state_dict())
        step, _ = make_train_step(model)
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.Generator().manual_seed(seed))))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("size", [(4, 4), (3, 5)])
def test_bilinear_upsample_matches_jax_resize_at_the_border(size):
    """DeepLab's upsample, 16x up: ``F.interpolate(bilinear,
    align_corners=False)`` against ``jax.image.resize(bilinear)`` on every
    pixel, the border rows and columns included, to float32 rounding."""
    h, w = size
    x = np.random.default_rng(8).normal(size=(2, h, w, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 16 * h, 16 * w, 3),
                                      method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(16 * h, 16 * w), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    scale = np.abs(x).max()
    for region in (np.s_[:, :8], np.s_[:, -8:], np.s_[:, :, :8],
                   np.s_[:, :, -8:], np.s_[:]):
        np.testing.assert_allclose(got[region], ref[region], rtol=0,
                                   atol=4e-7 * scale)


def test_registry_builds_every_case():
    """MODELS now holds every model of the reference's registry, and
    ``case_model`` builds each case's model for its published shape (VGG's
    fc1 from 224, the LSTM's input from its 300 features)."""
    assert set(MODELS) == set(JAX_MODELS)
    assert [c.model for c in BENCH_CASES] == [
        "resnet_v2_50"] * 2 + ["resnet_v2_152"] * 2 + ["vgg16"] * 2 + [
        "deeplab_v3"] * 2 + ["lstm"] * 2
    by_model = {c.model: c for c in BENCH_CASES}
    with torch.device("meta"):
        vgg = case_model(by_model["vgg16"], torch.bfloat16)
        lstm = case_model(by_model["lstm"], torch.bfloat16)
        deeplab = case_model(by_model["deeplab_v3"], torch.bfloat16)
    assert vgg.fc1.in_features == 7 * 7 * 512
    assert vgg.fc1.weight.numel() * 4 == 411_041_792  # 411 MB of f32
    assert lstm.lstm0.gates.in_features == 300 + 384
    assert deeplab.logits.out_channels == 21
