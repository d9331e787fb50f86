"""Parity of the port's training path (vtpu_torch/models/train.py,
norm.py's training mode, convert.py's momentum map) with the JAX package's
(vtpu/models/train.py) on the CPU, at small sizes.

Inputs come from a numpy seed, flax weights are carried across with
``from_flax``, and both frameworks take the same steps. Tolerances are those
of tests/test_torch_models.py: float32 ``max|Δ| <= 1e-4 * max|ref| + 1e-5``
per tensor; bfloat16 compute, relative error (L2 for the parameter
updates) ``<= 5e-2``.

The distributed cases run the port in gloo ranks spawned by
``run_ranks`` (their body is tests/test_torch_dist.py's ``parity_rank``)
and the reference on a mesh of the same shape over the 8 host devices
that tests/conftest.py forces.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_dist as td
from test_torch_models import assert_close, nchw, nhwc, randomize_stats
from vtpu.models.resnet import ResNetV2 as JaxResNetV2
from vtpu.models.train import build_sharded_train_step as jax_build_sharded
from vtpu.models.train import init_model as jax_init_model
from vtpu.models.train import make_mesh as jax_make_mesh
from vtpu.models.train import make_train_step as jax_make_train_step
from vtpu.models.train import shard_params as jax_shard_params
from vtpu_torch.models.convert import (
    from_flax,
    momentum_from_optax,
    momentum_to_optax,
)
from vtpu_torch.models.resnet import ResNetV2
from vtpu_torch.models.train import make_train_step, param_placements, run_ranks

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CLASSES = 10
STEPS = 3


def _flax_narrow(dtype):
    return JaxResNetV2(stage_sizes=(1, 1, 1, 1), width=8,
                       num_classes=CLASSES, dtype=dtype)


@functools.lru_cache(maxsize=None)
def narrow_variables():
    """float32 flax variables of the narrow ResNet, BN state randomized."""
    variables = jax.jit(_flax_narrow(jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 32, 32, 3), jnp.float32))
    return randomize_stats(variables["params"], variables["batch_stats"],
                           np.random.default_rng(10))


def batches():
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
             rng.integers(0, CLASSES, size=(8,)).astype(np.int32))
            for _ in range(STEPS)]


def run_both(kind):
    """STEPS steps of the port and of jax.jit(make_train_step) from the
    same weights; after each, the port's loss, state dict and momentum
    and the reference's, all converted to the port's names and layout."""
    jdt, tdt = DTYPES[kind]
    params, stats = narrow_variables()
    jstep, tx = jax_make_train_step(_flax_narrow(jdt))
    jstep = jax.jit(jstep)
    opt = tx.init(params)
    model = ResNetV2(stage_sizes=(1, 1, 1, 1), width=8, num_classes=CLASSES,
                     dtype=tdt)
    model.load_state_dict(from_flax(params, stats))
    step, optimizer = make_train_step(model)
    out = []
    for i, (x, y) in enumerate(batches()):
        params, opt, stats, ref = jstep(params, opt, stats, jnp.asarray(x),
                                        jnp.asarray(y), jax.random.PRNGKey(i))
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        out.append({
            "loss": float(loss), "ref_loss": float(ref),
            "state": {n: t.clone() for n, t in model.state_dict().items()},
            "ref_state": from_flax(params, stats),
            "momentum": {n: optimizer.state[p]["momentum_buffer"].clone()
                         for n, p in model.named_parameters()},
            "ref_momentum": momentum_from_optax(opt, model)})
    out[-1]["trace"] = (momentum_to_optax(optimizer, model), opt[0].trace)
    return out


@pytest.fixture(scope="module")
def runs():
    return {kind: run_both(kind) for kind in DTYPES}


def test_train_step_matches_flax_f32(runs):
    """Three SGD steps: loss, parameters, running statistics and momentum
    (through momentum_from_optax) after each, and the momentum carried
    back into flax's layout (momentum_to_optax) leaf by leaf."""
    for got in runs["f32"]:
        assert_close(got["loss"], got["ref_loss"], "f32")
        assert set(got["state"]) == set(got["ref_state"])
        for name, t in got["state"].items():
            assert_close(t, got["ref_state"][name], "f32")
        assert set(got["momentum"]) == set(got["ref_momentum"])
        for name, t in got["momentum"].items():
            assert_close(t, got["ref_momentum"][name], "f32")
    mine, trace = runs["f32"][-1]["trace"]
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(trace)
    jax.tree_util.tree_map(lambda a, b: assert_close(a, b, "f32"), mine,
                           trace)


def update(before, after, names=None):
    """after - before over ``names`` (default: every parameter), one
    float64 vector in name order."""
    names = sorted(names or (n for n in after if "running" not in n))
    return np.concatenate([np.asarray(after[n], np.float64).ravel()
                           - np.asarray(before[n], np.float64).ravel()
                           for n in names])


def rel_l2(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_train_step_matches_flax_bf16(runs):
    """bf16 compute with f32 parameters. Each step's loss within relative
    5e-2. The update of the first step (both sides start from the same
    weights): the head's (weight and bias, whose gradient bf16 rounding
    does not swamp) within relative L2 5e-2; the whole model's no further
    from the reference's f32 update than 1.25 times the reference's own
    bf16 update is. At this size bf16 rounding alone moves the whole
    update by ~30% in both frameworks (PERF.md), so the f32 test is the
    one that holds every parameter to the reference."""
    for got in runs["bf16"]:
        assert abs(got["loss"] - got["ref_loss"]) <= \
            5e-2 * abs(got["ref_loss"]), (got["loss"], got["ref_loss"])
    params0, stats0 = narrow_variables()
    start = from_flax(params0, stats0)
    first, f32 = runs["bf16"][0], runs["f32"][0]
    head = ["head.weight", "head.bias"]
    assert rel_l2(update(start, first["state"], head),
                  update(start, first["ref_state"], head)) <= 5e-2
    ref_f32 = update(start, f32["ref_state"])
    port_noise = rel_l2(update(start, first["state"]), ref_f32)
    ref_noise = rel_l2(update(start, first["ref_state"]), ref_f32)
    assert port_noise <= 1.25 * ref_noise, (port_noise, ref_noise)


def test_momentum_from_optax_refuses_a_state_without_trace():
    model = ResNetV2(stage_sizes=(1, 1, 1, 1), width=8, num_classes=CLASSES)
    with pytest.raises(ValueError, match="trace"):
        momentum_from_optax(((), ()), model)


# ------------------------------------------------------- distributed cases


def _flax_sharded():
    return JaxResNetV2(stage_sizes=(1, 1, 1, 1), width=64,
                       dtype=jnp.float32)


def _bn_case(rng):
    """A float32 flax BatchNorm on a (4, 6, 5, 5) batch: input, torch state
    and the reference's output and updated statistics on the whole
    batch."""
    x = rng.normal(1.0, 2.0, size=(4, 5, 5, 6)).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    variables = jax.jit(jbn.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = randomize_stats(variables["params"],
                                    variables["batch_stats"], rng)
    out, updates = jbn.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), mutable=["batch_stats"])
    return ({"x": nchw(x), "state": from_flax(params, stats)},
            {"out": np.asarray(out), "mean": np.asarray(
                updates["batch_stats"]["mean"]),
             "var": np.asarray(updates["batch_stats"]["var"])})


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The port's ranks, spawned once for every case: four gloo ranks; the
    first two run the BatchNorm case, and each mesh runs on the first
    dp * tp of them. All start from the reference's initial state
    (PRNGKey(0), as build_sharded_train_step draws it), copied to
    numpy."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 1000, size=(8,)).astype(np.int32)
    params, stats = jax.jit(functools.partial(
        jax_init_model, _flax_sharded()))(jnp.asarray(x))
    params, stats = jax.tree_util.tree_map(np.array, (params, stats))
    bn_in, bn_ref = _bn_case(rng)
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save({"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                "state": from_flax(params, stats), "bn": bn_in},
               tmp / "in.pt")
    run_ranks(td.parity_rank, td.WORLD, "cpu",
              args=(str(tmp / "in.pt"), str(tmp)),
              init_file=str(tmp / "rendezvous"), timeout_s=300)
    out = torch.load(tmp / "results.pt", weights_only=False)
    return {"x": x, "y": y, "params": params, "stats": stats,
            "bn_ref": bn_ref, "port": out}


def test_batchnorm_global_statistics_over_two_ranks(dist_runs):
    """Each rank normalises its half of the batch with the statistics of
    the whole batch (Σx, Σx², count all-reduced), and both update their
    running statistics as flax does on the whole batch."""
    got, ref = dist_runs["port"]["bn"], dist_runs["bn_ref"]
    assert_close(nhwc(got["out"]), ref["out"], "f32")
    np.testing.assert_allclose(got["running_mean"].numpy(), ref["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["running_var"].numpy(), ref["var"],
                               rtol=1e-5, atol=1e-6)


def _torch_name(path):
    keys = [k.key for k in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf])


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_matches_jax(dist_runs, dp, tp):
    """One step of build_sharded_train_step on a (dp, tp) mesh against the
    reference's on a JAX mesh of the same shape: loss, parameters,
    momentum and running statistics within the float32 tolerance, and the
    same parameters sharded over tp."""
    mesh = jax_make_mesh(devices=jax.devices()[:dp * tp], dp=dp, tp=tp)
    x, y = jnp.asarray(dist_runs["x"]), jnp.asarray(dist_runs["y"])
    step, (params, opt, stats) = jax_build_sharded(_flax_sharded(), x, y,
                                                   mesh)
    for got, want in zip(jax.tree_util.tree_leaves((params, stats)),
                         jax.tree_util.tree_leaves((dist_runs["params"],
                                                    dist_runs["stats"]))):
        np.testing.assert_array_equal(np.asarray(got), want)
    jax_sharded = sorted(
        _torch_name(path) for path, s in
        jax.tree_util.tree_leaves_with_path(jax_shard_params(params, mesh))
        if s.spec != P())
    # the step donates its state
    params, opt, stats, loss = step(params, opt, stats, x, y,
                                    jax.random.PRNGKey(0))
    port = dist_runs["port"][(dp, tp)]
    assert port["sharded"] == jax_sharded
    assert any(".conv3." in n for n in jax_sharded) and "head.weight" in \
        jax_sharded
    assert_close(port["loss"], float(loss), "f32")
    want = from_flax(params, stats)
    for name, t in {**port["params"], **port["stats"]}.items():
        assert_close(t, want[name], "f32")
    momentum = momentum_from_optax(opt, td.sharded_model())
    for name, t in port["momentum"].items():
        assert_close(t, momentum[name], "f32")


def test_indivisible_wide_tensor_is_replicated_as_in_jax():
    """A 257-wide tensor passes the threshold but not tp=2: both rules
    replicate it (tests/test_models.py:108-113)."""
    mesh = jax_make_mesh(devices=jax.devices()[:2], dp=1, tp=2)
    shardings = jax_shard_params({"w": jnp.ones((4, 257))}, mesh)
    assert shardings["w"].spec == P()
    # flax [in, out] = [4, 257] is torch [out, in] = [257, 4]
    assert not param_placements((257, 4), 2)[1].is_shard()
    assert param_placements((256, 4), 2)[1].is_shard()
