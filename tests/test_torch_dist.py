"""The port's distributed training path on the CPU, without the reference:
the sharding rule, ``dryrun_multichip`` over gloo ranks, and the rank
bodies that tests/test_torch_train.py runs against the JAX package.

The ranks are spawned processes (``vtpu_torch.models.train.run_ranks``)
that meet at a file under the test's temporary directory, never at a fixed
TCP port, so parallel test workers cannot collide. They import this module
to find their body, and it imports torch and the port only, so a rank
starts without loading JAX.
"""

import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

import vtpu_torch
from vtpu_torch.models.norm import BatchNorm
from vtpu_torch.models.resnet import ResNetV2
from vtpu_torch.models.train import (
    build_sharded_train_step,
    make_mesh,
    make_train_step,
    param_placements,
    run_ranks,
)

# the (dp, tp) meshes of the parity tests; the ranks of one spawn take them
# in turn, each on the first dp * tp ranks
MESHES = [(2, 1), (1, 2), (2, 2)]
WORLD = 4


def sharded_model():
    """The narrowest ResNet-V2 whose conv3/proj outputs (256..2048) reach
    the tp threshold, in float32."""
    return ResNetV2(stage_sizes=(1, 1, 1, 1), width=64, dtype=torch.float32)


def parity_rank(rank, in_path, out_dir):
    """Rank body for tests/test_torch_train.py, in a world of WORLD ranks.
    ``in_path`` holds the reference's state dict, batch and BatchNorm case;
    rank 0 writes the results of the BatchNorm case (ranks 0 and 1) and of
    every mesh to ``out_dir``/results.pt."""
    data = torch.load(in_path, weights_only=False)
    out = {}
    pair = dist.new_group([0, 1])  # every rank takes part in making it
    if rank < 2:
        bn_case = data["bn"]
        bn = BatchNorm(bn_case["x"].shape[1], dtype=torch.float32,
                       process_group=pair)
        bn.load_state_dict(bn_case["state"])
        half = bn_case["x"].shape[0] // 2
        y = bn.train()(bn_case["x"][rank * half:(rank + 1) * half])
        parts = [torch.empty_like(y) for _ in range(2)]
        dist.all_gather(parts, y.detach(), group=pair)
        out["bn"] = {"out": torch.cat(parts),
                     "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    for dp, tp in MESHES:
        if dp * tp == dist.get_world_size():
            mesh = make_mesh("cpu", dp=dp, tp=tp)
        else:  # a mesh over the first ranks; the others make it too
            mesh = DeviceMesh("cpu", torch.arange(dp * tp).reshape(dp, tp),
                              mesh_dim_names=("dp", "tp"))
        if rank >= dp * tp:
            continue
        model = sharded_model()
        step, (params, momentum, stats) = build_sharded_train_step(
            model, data["x"], data["y"], mesh)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(distribute_tensor(data["state"][name], mesh,
                                          p.placements))
            for name, b in stats.items():
                b.copy_(data["state"][name])
        loss = step(data["x"], data["y"])
        out[(dp, tp)] = {
            "loss": float(loss),
            "params": {n: p.detach().full_tensor() for n, p in params.items()},
            "momentum": {n: m.full_tensor() for n, m in momentum.items()},
            "stats": {n: b.clone() for n, b in stats.items()},
            "sharded": sorted(n for n, p in params.items()
                              if p.placements[1].is_shard()),
        }
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "results.pt"))


def test_param_placements_follow_the_reference_rule():
    """Shard(0) over tp for rank >= 2 with >= 256 output features divisible
    by tp (vtpu/models/train.py:37-60); everything else replicated."""
    def sharded(shape, tp):
        return param_placements(shape, tp)[1].is_shard()

    assert sharded((256, 64, 1, 1), 2) and sharded((1000, 2048), 2)
    assert sharded((2048, 512, 3, 3), 1)
    assert not sharded((255, 64, 1, 1), 2)   # below the threshold
    assert not sharded((257, 8), 2)          # indivisible: replicated
    assert not sharded((2048,), 2)           # rank 1
    assert not param_placements((512, 8), 2)[0].is_shard()  # never over dp


def test_make_train_step_refuses_statistics_it_would_not_update():
    with pytest.raises(ValueError, match="BatchNorm"):
        make_train_step(sharded_model(), has_batch_stats=False)


def test_dryrun_multichip_over_two_gloo_ranks():
    """Two ranks, a 1x2 mesh: the whole sharded path of ResNet-V2-50 runs
    one step and the loss is finite (the rank raises otherwise)."""
    vtpu_torch.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_refuses_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vtpu_torch.dryrun_multichip(1)


def failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")


def test_run_ranks_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(failing_rank, 2, "cpu",
                  init_file=str(tmp_path / "rendezvous"), timeout_s=120)
