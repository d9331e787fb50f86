"""Prints the errors that tests/test_torch_models.py and
tests/test_torch_slice.py bound, case by case, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

float32 rows give max|Δ| / max|ref| (the tests allow 1e-4 plus 1e-5
absolute); bfloat16 rows give the relative L2 error (the tests allow
5e-2).
"""

import os
import sys
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_models as t  # noqa: E402
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
    for name, kind, err in rows:
        print(f"{name:32s} {kind:5s} {err:.3e}")


if __name__ == "__main__":
    main()
