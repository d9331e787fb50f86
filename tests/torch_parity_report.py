"""Prints the errors that tests/test_torch_models.py,
tests/test_torch_slice.py and tests/test_torch_train.py bound, case by
case, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

float32 rows give max|Δ| / max|ref| (the tests allow 1e-4 plus 1e-5
absolute), the worst tensor of the case; bfloat16 rows give the relative
L2 error (the tests allow 5e-2), or the relative error of a loss.
"""

import os
import sys
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
# the 8 host devices tests/conftest.py forces, for the sharded cases' meshes
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_models as t  # noqa: E402
import test_torch_train as tt  # noqa: E402
import vtpu_torch  # noqa: E402
from vtpu.models import get_model as jax_get_model  # noqa: E402
from vtpu.models.train import init_model as jax_init_model  # noqa: E402
from vtpu_torch.models import get_model  # noqa: E402
from vtpu_torch.models.convert import from_flax  # noqa: E402
from vtpu_torch.models.resnet import (  # noqa: E402
    BottleneckV2, resnet_stem, stem_conv)
from vtpu_torch.models.train import make_infer_step  # noqa: E402


def error(got, ref, kind):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if kind == "f32":
        return np.abs(got - ref).max() / np.abs(ref).max()
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def main():
    rows = []
    for kind, (jdt, tdt) in sorted(t.DTYPES.items()):
        for block, (cin, filters, strides, rate, hw) in sorted(
                t.BLOCKS.items()):
            x = np.random.default_rng(1).normal(
                size=(2, hw, hw, cin)).astype(np.float32)
            ref, params, stats = t.flax_run(t._flax_block(block), x, jdt)
            m = BottleneckV2(cin, filters, strides=strides, rate=rate,
                             dtype=tdt)
            m.load_state_dict(from_flax(params, stats))
            with torch.no_grad():
                out = m.eval()(t.nchw(x).to(tdt))
            rows.append((f"bottleneck {block}", kind,
                         error(t.nhwc(out), ref, kind)))
        x = np.random.default_rng(2).normal(size=(2, 35, 35, 3)).astype(
            np.float32)
        ref, params, stats = t.flax_run(t._flax_stem, x, jdt)
        holder = torch.nn.Module()
        holder.conv_root = stem_conv(3, 8, tdt)
        holder.load_state_dict(from_flax(params, stats))
        with torch.no_grad():
            out = resnet_stem(t.nchw(x).to(tdt), holder.conv_root)
        rows.append(("stem 35x35", kind, error(t.nhwc(out), ref, kind)))
        for name, (make_flax, make_port) in sorted(t.WHOLE.items()):
            x = np.random.default_rng(3).normal(
                size=(2, 32, 32, 3)).astype(np.float32)
            params, stats = t.flax_variables(make_flax, x.shape)
            ref = np.asarray(jax.jit(t.jax_make_infer_step(make_flax(jdt)))(
                params, stats, jnp.asarray(x)))
            model = make_port(tdt)
            model.load_state_dict(from_flax(params, stats))
            out = make_infer_step(model)(torch.from_numpy(x))
            rows.append((f"{name} 2x32x32", kind,
                         error(out.numpy(), ref, kind)))
    # the slice as a whole: tests/test_torch_slice.py's entry comparison
    fn, (x,) = vtpu_torch.entry(device="cpu")
    jax_model = jax_get_model("resnet_v2_50")
    jx = jnp.asarray(x.numpy())
    params, stats = jax.jit(partial(jax_init_model, jax_model))(jx)
    ref = np.asarray(jax.jit(t.jax_make_infer_step(jax_model))(
        params, stats, jx))
    model = get_model("resnet_v2_50")
    model.load_state_dict(from_flax(params, stats))
    rows.append(("entry() 8x224x224", "bf16",
                 error(make_infer_step(model)(x).numpy(), ref, "bf16")))
    rows += train_rows()
    rows += reference_noise_rows()
    for name, kind, err in rows:
        print(f"{name:52s} {kind:5s} {err:.3e}")


def worst(got: dict, ref: dict) -> float:
    return max(error(got[n], ref[n], "f32") for n in ref)


def train_rows():
    """tests/test_torch_train.py's cases."""
    import pathlib
    import tempfile

    rows = []
    runs = {kind: tt.run_both(kind) for kind in tt.DTYPES}
    for i, got in enumerate(runs["f32"]):
        rows.append((f"train step {i + 1}: loss", "f32",
                     error(got["loss"], got["ref_loss"], "f32")))
        rows.append((f"train step {i + 1}: params + running stats", "f32",
                     worst(got["state"], got["ref_state"])))
        rows.append((f"train step {i + 1}: momentum", "f32",
                     worst(got["momentum"], got["ref_momentum"])))
    for i, got in enumerate(runs["bf16"]):
        rows.append((f"train step {i + 1}: loss (relative)", "bf16",
                     abs(got["loss"] - got["ref_loss"])
                     / abs(got["ref_loss"])))
    params0, stats0 = tt.narrow_variables()
    start = from_flax(params0, stats0)
    first, f32 = runs["bf16"][0], runs["f32"][0]
    head = ["head.weight", "head.bias"]
    rows.append(("train step 1: head update", "bf16", tt.rel_l2(
        tt.update(start, first["state"], head),
        tt.update(start, first["ref_state"], head))))
    ref_f32 = tt.update(start, f32["ref_state"])
    for who, state in (("port", first["state"]),
                       ("reference", first["ref_state"])):
        rows.append((f"train step 1: update, {who} bf16 vs ref f32",
                     "bf16", tt.rel_l2(tt.update(start, state), ref_f32)))
    rows.append(("train step 1: update, port bf16 vs ref bf16", "bf16",
                 tt.rel_l2(tt.update(start, first["state"]),
                           tt.update(start, first["ref_state"]))))

    class Tmp:
        def mktemp(self, name):
            return pathlib.Path(tempfile.mkdtemp(prefix=name))

    dist = tt.dist_runs.__wrapped__(Tmp())
    bn = dist["port"]["bn"]
    rows.append(("BatchNorm, 2 ranks, global stats: output", "f32",
                 error(t.nhwc(bn["out"]), dist["bn_ref"]["out"], "f32")))
    rows.append(("BatchNorm, 2 ranks: running mean", "f32",
                 error(bn["running_mean"], dist["bn_ref"]["mean"], "f32")))
    rows.append(("BatchNorm, 2 ranks: running var", "f32",
                 error(bn["running_var"], dist["bn_ref"]["var"], "f32")))
    x, y = jnp.asarray(dist["x"]), jnp.asarray(dist["y"])
    model = tt.td.sharded_model()
    for dp, tp in sorted(k for k in dist["port"] if isinstance(k, tuple)):
        mesh = tt.jax_make_mesh(devices=jax.devices()[:dp * tp], dp=dp,
                                tp=tp)
        step, (p, o, s) = tt.jax_build_sharded(tt._flax_sharded(), x, y,
                                               mesh)
        p, o, s, loss = step(p, o, s, x, y, jax.random.PRNGKey(0))
        port = dist["port"][(dp, tp)]
        want = from_flax(p, s)
        rows.append((f"sharded step ({dp},{tp}): loss", "f32",
                     error(port["loss"], float(loss), "f32")))
        rows.append((f"sharded step ({dp},{tp}): params + stats", "f32",
                     worst({**port["params"], **port["stats"]}, want)))
        rows.append((f"sharded step ({dp},{tp}): momentum", "f32",
                     worst(port["momentum"],
                           tt.momentum_from_optax(o, model))))
    return rows


def reference_noise_rows():
    """How far the JAX reference moves from itself, which bounds what any
    comparison with it can show: its bf16 SGD update against its f32 one
    (ResNet-V2-50, one step at 4x64x64), and its dp=2 sharded step against
    its unsharded one, in multiples of the f32 tolerance (the width-64
    model of the sharded tests at batch 8; 16x16 is the tests' size)."""
    from vtpu.models.resnet import resnet_v2_50 as jax_resnet_v2_50
    from vtpu.models.train import make_train_step as jax_make_train_step

    rows = []
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 64, 64, 3))
    y = jax.random.randint(jax.random.PRNGKey(2), (4,), 0, 1000)
    params, stats = jax.jit(partial(jax_init_model,
                                    jax_resnet_v2_50(dtype=jnp.float32)))(x)
    updates = {}
    for kind, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        step, tx = jax_make_train_step(jax_resnet_v2_50(dtype=dt))
        new, _, _, _ = jax.jit(step)(params, tx.init(params), stats, x, y,
                                     jax.random.PRNGKey(0))
        updates[kind] = np.concatenate([
            np.ravel(np.asarray(a, np.float64) - np.asarray(b, np.float64))
            for a, b in zip(jax.tree_util.tree_leaves(new),
                            jax.tree_util.tree_leaves(params))])
    rows.append(("reference ResNet-V2-50 4x64x64: bf16 vs f32 update",
                 "bf16", error(updates["bf16"], updates["f32"], "bf16")))

    model = tt.td.sharded_model()
    for hw in (16, 64):
        rng = np.random.default_rng(12)
        x = jnp.asarray(rng.normal(size=(8, hw, hw, 3)).astype(np.float32))
        y = jnp.asarray(rng.integers(0, 1000, size=(8,)).astype(np.int32))
        momenta = {}
        for dp in (1, 2):
            mesh = tt.jax_make_mesh(devices=jax.devices()[:dp], dp=dp, tp=1)
            step, (p, o, s) = tt.jax_build_sharded(tt._flax_sharded(), x, y,
                                                   mesh)
            _, o, _, _ = step(p, o, s, x, y, jax.random.PRNGKey(0))
            momenta[dp] = tt.momentum_from_optax(o, model)
        ratio = max(
            float((momenta[2][n] - momenta[1][n]).abs().max())
            / (1e-4 * float(momenta[1][n].abs().max()) + 1e-5)
            for n in momenta[1])
        rows.append((f"reference dp=2 vs unsharded, width 64, 8x{hw}x{hw}: "
                     f"momentum / f32 tolerance", "f32", ratio))
    return rows


if __name__ == "__main__":
    main()
