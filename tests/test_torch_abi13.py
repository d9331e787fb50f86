"""The entry points a CUDA 13.0 driver resolves that had no hook:
libvgpu.so on the mock libcuda.so.1, which answers each base name as the
H100's driver 580.159.03 does (``python -m vtpu_torch.bench.abi`` there:
``cuCtxSynchronize`` at 13000 is ``cuCtxSynchronize_v2``, which takes a
context; ``cuMemcpyBatchAsync`` and ``cuMemcpy3DBatchAsync`` are CUDA
12.8's at 12080 and their ``_v2``, which take no ``failIdx``, at 13000,
each with a ``_ptsz`` twin under the per-thread-stream flag), through
``python -m vtpu_torch.bench.cuda13 --backend mock``, the probe
chip_smoke.py's phase (s) runs on the card.
"""

from vtpu_torch.bench import cuda13


def test_cuda_13_sync_and_batch_copies_through_the_interposer():
    """CUDA 13.0's synchronisation, handed out hooked at 13000, ends the
    span a 50 ms kernel opened on the default stream and charges it when
    it returns, not before (before the hook the driver's _v2 ran unhooked
    and the span stayed open until a later launch or exit), with the
    context named and with NULL (the current one) alike. Each of the
    eight batch variants is handed out hooked, reaches the driver and is
    noted as one TRANSFER with its 1 MiB, as every other copy entry point
    is (tests/test_torch_prof.py); a 3D batch the driver refuses (a flag
    set) is one TRANSFER error with no bytes."""
    res = cuda13.run("mock")
    assert res["ok"], res
    assert res["sync_rc"] == [0, 0]
    for ms in res["sync_charged_ms"]:
        assert 0.95 * 50 <= ms <= 1.1 * 50, res
    assert len(res["batches"]) == 4
    assert res["refused_rc"] == 1  # CUDA_ERROR_INVALID_VALUE
    assert res["transfer"] == [9, 1, 8 * cuda13.COPY_BYTES]
