"""The port's sharded serving model held to the JAX package's.

``vtpu_torch.models.serving`` against ``vtpu.models.serving`` on the CPU:

- ``MeshSpec.from_env`` over a table of good and malformed envs: the same
  shape, coordinate, axes, member count and index;
- gangs of 1, 2 and 4 members at 8/16/4 and the reference's defaults
  64/256/16, on the weights JAX's ``_full_params()`` draws, carried across
  with ``convert.serving_params_from_jax``: each member's partial logits
  and the combined logits within rtol 1e-5 of the JAX gang's (and of each
  side's unsharded reference). The JAX side runs as its own tests run it:
  ``shard_map`` over the eight virtual CPU devices of tests/conftest.py;
  the port splits its batch over eight CPU devices alike
  (``device=["cpu"] * 8``) and over one;
- the errors the two raise alike: a hidden width the gang does not divide,
  a batch the local devices do not divide, no partials, partials of two
  shapes;
- the stats: member, members, local devices, hidden shard, parameter
  bytes, requests, and ``record_step`` stamped by ``infer``.
"""

import numpy as np
import pytest
import torch

from vtpu.models import serving as jax_serving
from vtpu_torch import api
from vtpu_torch.models import convert, serving

RTOL = 1e-5
ATOL = 1e-6
EIGHT_CPUS = ["cpu"] * 8


def mesh_env(shape, coord, axes="x,y,z"):
    return {api.ENV_MESH_SHAPE: shape, api.ENV_MESH_COORDS: coord,
            api.ENV_MESH_AXES: axes}


ENVS = [
    {},
    mesh_env("2,1,1", "0-0-0"),
    mesh_env("2,1,1", "1-0-0"),
    mesh_env("2,2,1", "1-1-0"),
    mesh_env("4", "3", "hosts"),
    mesh_env("2,2", "1-0", "a,b,c"),       # axes of another rank
    mesh_env("2,2", "1-0", ""),             # no axes
    mesh_env("2,1,1", "2-0-0"),             # coordinate outside the box
    mesh_env("2,x,1", "0-0-0"),             # not an int
    mesh_env("2,1,1", "0-0"),               # ranks differ
    mesh_env("0,1,1", "0-0-0"),             # empty axis
    mesh_env("2,1,1", "-1-0-0"),            # negative
    mesh_env("", "0-0-0"),                  # no shape
    {api.ENV_MESH_SHAPE: "2,1,1"},          # no coordinate
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: repr(sorted(
    e.values())))
def test_mesh_spec_from_env_matches_the_reference(env):
    j = jax_serving.MeshSpec.from_env(env)
    p = serving.MeshSpec.from_env(env)
    assert (p.shape, p.coord, p.axes, p.num_members, p.linear_index) == \
        (j.shape, j.coord, j.axes, j.num_members, j.linear_index)


def test_mesh_spec_reads_the_process_env(monkeypatch):
    for k, v in mesh_env("2,1,1", "1-0-0").items():
        monkeypatch.setenv(k, v)
    assert serving.MeshSpec.from_env() == serving.MeshSpec(
        shape=(2, 1, 1), coord=(1, 0, 0))
    assert jax_serving.MeshSpec.from_env().linear_index == 1


def member_envs(n):
    return [mesh_env(f"{n},1,1", f"{m}-0-0") for m in range(n)]


def carried(dim, hidden, classes, seed=0):
    """JAX's full weights (its PRNG) and the same weights as the port's
    host tensors"""
    ref = jax_serving.ShardedServingModel(
        mesh=jax_serving.MeshSpec(), dim=dim, hidden=hidden,
        classes=classes, seed=seed)
    jw = [np.asarray(a) for a in ref._full_params()]
    return jw, convert.serving_params_from_jax(*jw)


SIZES = [(8, 16, 4), (64, 256, 16)]


@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("local", ["8 cpus", "1 cpu"])
def test_gang_partials_and_combined_logits_match_the_reference(
        members, size, local):
    dim, hidden, classes = size
    jw, params = carried(dim, hidden, classes)
    assert [tuple(t.shape) for t in params] == [a.shape for a in jw]
    x = np.random.RandomState(7).randn(16, dim).astype(np.float32)
    device = EIGHT_CPUS if local == "8 cpus" else "cpu"
    jax_parts, port_parts = [], []
    for env in member_envs(members):
        jout, jstats = jax_serving.run_member(
            env, x, dim=dim, hidden=hidden, classes=classes)
        pout, pstats = serving.run_member(
            env, x, params=params, dim=dim, hidden=hidden, classes=classes,
            device=device)
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
        assert (pstats.member, pstats.members, pstats.hidden_shard,
                pstats.param_bytes, pstats.requests) == \
            (jstats.member, jstats.members, jstats.hidden_shard,
             jstats.param_bytes, jstats.requests)
        assert pstats.local_devices == (8 if local == "8 cpus" else 1)
        assert pstats.last_step_seconds > 0.0
        jax_parts.append(jout)
        port_parts.append(pout)
    jcombined = np.asarray(jax_serving.combine_partials(jax_parts))
    combined = serving.combine_partials(port_parts).numpy()
    np.testing.assert_allclose(combined, jcombined, rtol=RTOL, atol=ATOL)
    ref = serving.reference_logits(x, dim, hidden, classes, device="cpu",
                                   params=params).numpy()
    np.testing.assert_allclose(ref, np.asarray(jax_serving.reference_logits(
        x, dim, hidden, classes)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(combined, ref, rtol=RTOL, atol=ATOL)


def test_the_seed_draws_one_model_for_every_member():
    """Without carried weights each member draws the full model from the
    shared seed (a host torch.Generator) and slices it: the gang's sum is
    the port's own unsharded reference."""
    x = np.random.RandomState(3).randn(8, 64).astype(np.float32)
    parts = [serving.run_member(env, x, hidden=256, device="cpu")[0]
             for env in member_envs(4)]
    ref = serving.reference_logits(x, device="cpu")
    np.testing.assert_allclose(serving.combine_partials(parts).numpy(),
                               ref.numpy(), rtol=RTOL, atol=ATOL)
    a = serving.ShardedServingModel(seed=5, device="cpu")._full_params()
    b = serving.ShardedServingModel(seed=5, device="cpu")._full_params()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_are_raised_alike():
    env3 = mesh_env("3,1,1", "0-0-0")
    assert _raised(lambda: serving.ShardedServingModel(
        env=env3, hidden=256, device="cpu")) == _raised(
        lambda: jax_serving.ShardedServingModel(env=env3, hidden=256))
    # a batch the eight local devices do not divide
    x = np.ones((4, 64), np.float32)
    jm = jax_serving.ShardedServingModel()
    pm = serving.ShardedServingModel(device=EIGHT_CPUS)
    jm.setup()
    pm.setup()
    assert _raised(lambda: pm.infer(x)) == _raised(lambda: jm.infer(x))
    assert _raised(lambda: serving.combine_partials([])) == _raised(
        lambda: jax_serving.combine_partials([]))
    a, b = np.ones((4, 8), np.float32), np.ones((2, 8), np.float32)
    assert _raised(lambda: serving.combine_partials(
        [torch.from_numpy(a), torch.from_numpy(b)])) == _raised(
        lambda: jax_serving.combine_partials([a, b]))
    # the port's own: carried weights that do not fit the model
    _, params = carried(8, 16, 4)
    with pytest.raises(ValueError, match="do not fit"):
        serving.ShardedServingModel(device="cpu").setup(params)


def test_infer_stamps_the_step_accessor_as_the_reference():
    stats = serving.ServingStats()
    assert stats.mean_step_seconds == 0.0
    stats.record_step(0.02)
    stats.record_step(0.04)
    assert (stats.requests, stats.last_step_seconds) == (2, 0.04)
    assert stats.mean_step_seconds == pytest.approx(0.03)
    model = serving.ShardedServingModel(dim=8, hidden=16, classes=4,
                                        device=EIGHT_CPUS)
    model.setup()
    assert model.stats.local_devices == 8
    out = model.infer(np.ones((8, 8), np.float32))
    assert tuple(out.shape) == (8, 4) and out.device.type == "cpu"
    assert model.stats.requests == 1
    assert model.stats.last_step_seconds > 0.0
    assert model.stats.mean_step_seconds == pytest.approx(
        model.stats.last_step_seconds)
    model.close()
    # the field set the gateway consumes, field for field
    assert [f for f in serving.ServingStats.__dataclass_fields__] == \
        [f for f in jax_serving.ServingStats.__dataclass_fields__]


def test_param_bytes_at_the_wide_configuration():
    """The card's configuration (dim 8192, hidden 28672, classes 8192,
    f32; Llama-2-70B's hidden and MLP widths): a member of two holds
    939,581,440 B, a solo replica 1,879,162,880 B. Reckoned from the
    shapes, on meta tensors: nothing is allocated."""
    dim, hidden, classes = 8192, 28672, 8192
    full = (torch.empty(dim, hidden, device="meta"),
            torch.empty(hidden, device="meta"),
            torch.empty(hidden, classes, device="meta"))
    got = []
    for env in [{}] + member_envs(2):
        m = serving.ShardedServingModel(env=env, dim=dim, hidden=hidden,
                                        classes=classes, device="meta")
        got.append(m.setup(params=full).param_bytes)
        assert m.stats.hidden_shard == hidden // m.mesh.num_members
    assert got == [1_879_162_880, 939_581_440, 939_581_440]
