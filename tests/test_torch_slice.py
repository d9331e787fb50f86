"""The port's first slice as a whole, on the CPU: the entry point against
the JAX package's (__graft_entry__.entry), and the workload side of the
quota path — install() in a process that has libvgpu.so preloaded, with
the mock libcuda.so.1 standing in for the driver."""

import json
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtpu_torch
from vtpu.models import get_model as jax_get_model
from vtpu.models.train import init_model as jax_init_model
from vtpu.models.train import make_infer_step as jax_make_infer_step
from vtpu_torch import api, native
from vtpu_torch.enforce.region import RegionView
from vtpu_torch.models import get_model
from vtpu_torch.models.convert import from_flax
from vtpu_torch.models.train import make_infer_step


def test_entry_matches_reference_entry():
    """``vtpu_torch.entry(device="cpu")`` is __graft_entry__.entry():
    ResNet-V2-50 in bf16 on a batch of 8 ones at 224x224; with the flax
    entry's weights carried across, the logits agree within the bf16
    tolerance of tests/test_torch_models.py (relative L2 <= 5e-2)."""
    fn, (x,) = vtpu_torch.entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and bool((x == 1).all())
    out = fn(x)
    assert out.shape == (8, 1000) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())

    jax_model = jax_get_model("resnet_v2_50")
    jx = jnp.ones((8, 224, 224, 3), jnp.float32)
    params, stats = jax.jit(partial(jax_init_model, jax_model))(jx)
    ref = np.asarray(jax.jit(jax_make_infer_step(jax_model))(params, stats,
                                                             jx))
    model = get_model("resnet_v2_50")
    model.load_state_dict(from_flax(params, stats))
    got = make_infer_step(model)(x).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 5e-2, rel


def test_entry_refuses_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vtpu_torch.entry(device=device)
    assert vtpu_torch.resolve_device("cpu").type == "cpu"


CHILD = textwrap.dedent("""
    import json, sys
    import torch
    from vtpu_torch.enforce import install
    from vtpu_torch.models.resnet import ResNetV2
    from vtpu_torch.models.train import init_model, make_infer_step

    enf = install()
    model = ResNetV2(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    x = torch.ones(2, 32, 32, 3)
    init_model(model, x, torch.Generator().manual_seed(0))
    out = make_infer_step(model)(x)
    print(json.dumps({"interposed": enf.interposed,
                      "limit": enf.limit(),
                      "shape": list(out.shape),
                      "finite": bool(torch.isfinite(out).all())}),
          flush=True)
    sys.stdin.readline()
""")


def test_install_under_the_interposer(tmp_path):
    """The workload half of the quota path: a PyTorch process started with
    libvgpu.so preloaded imports torch under the interposer's dlsym, finds
    the interposer from install(), runs the model, and is seen by the
    monitor's RegionView until it exits, after which the region is clean."""
    cache = tmp_path / "containers" / "pod-uid_0" / "vgpu.cache"
    cache.parent.mkdir(parents=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "LD_LIBRARY_PATH": native.mock_cuda_dir(),
        "PYTHONPATH": root,
        api.ENV_DEVICE_MEMORY_LIMIT: "12g",
        api.ENV_SHARED_CACHE: str(cache),
    })
    proc = subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        report = json.loads(line)
        assert report == {"interposed": True, "limit": 12 << 30,
                          "shape": [2, 10], "finite": True}
        with RegionView(str(cache)) as view:
            assert [p.pid for p in view.procs()] == [proc.pid]
            assert view.hbm_limit(0) == 12 << 30
        _, err = proc.communicate("exit\n", timeout=120)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert proc.returncode == 0, err
    with RegionView(str(cache)) as view:
        assert view.procs() == [] and view.used(0) == 0
