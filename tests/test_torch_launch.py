"""The launch path of the port's kernel wrappers and what surrounds the
kernels shaped for the card, as far as a machine without a GPU can run
them: the choice of K1's, K3's and K4's slices of features, ``_build.launch`` against
a stand-in for the library and the CUDA runtime, ``_zero_grads``' one
allocation, and ``table_gather`` on CPU tensors (its plain twin).
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build
from nerfacc_tpu_torch.ops import (
    cp_features_slice_width,
    cp_grads_slice_width,
    cp_level_grads_slice_width,
    cp_level_grads_staged,
    table_gather,
    table_gather_plain,
)
from nerfacc_tpu_torch.ops import cp_encoder

torch.set_num_threads(1)

# the shared memory a block may use on Hopper, 227 KB
SHARED_BYTES = 232448


@pytest.mark.parametrize("G,R,want", [
    (128, 64, 64),    # the coarse flagship level: all features, 96 KB
    (512, 128, 32),   # the fine one: four slices of 32, 192 KB
    (33, 8, 8),       # R below a warp's 32 features
    (33, 48, 48),     # R not a multiple of 32, fits whole
    (512, 48, 32),    # R not a multiple of 32, sliced: 32 and 16
    (512, 33, 33),
    (605, 32, 32),    # the largest G whose 32 features fit
    (606, 32, 0),
    (1024, 128, 0),   # the global-atomic route
    (4096, 8, 0),
])
def test_cp_grads_slice_width(G, R, want):
    width = cp_grads_slice_width(G, R)
    assert width == want
    assert 0 <= width <= R
    assert 3 * G * width * 4 <= SHARED_BYTES
    assert cp_encoder.SHARED_BYTES_PER_BLOCK == SHARED_BYTES
    if 0 < width < R:
        # sliced: whole warps, and nothing larger would fit
        assert width % 32 == 0
        assert 3 * G * (width + 32) * 4 > SHARED_BYTES or width + 32 >= R
    if width == 0:
        assert 3 * G * min(R, 32) * 4 > SHARED_BYTES


def test_cp_grads_slice_width_follows_the_budget():
    assert cp_grads_slice_width(512, 128, budget=48 * 1024) == 0
    assert cp_grads_slice_width(128, 64, budget=48 * 1024) == 32
    assert cp_grads_slice_width(128, 64, budget=3 * 128 * 64 * 4) == 64


@pytest.mark.parametrize("G,R,want", [
    (128, 64, 64),     # the coarse flagship level: whole, 48 KB of bf16
    (512, 128, 64),    # the fine one: two slices of 64, 192 KB
    (128, 128, 128),   # 96 KB: all 128 features, a warp per sample
    (512, 96, 32),     # 32 divides 96, 64 does not
    (1210, 32, 32),    # the largest G whose 32 features fit
    (1211, 32, 0),
    (2048, 128, 0),    # tables beyond a block: read from device memory
    (33, 8, 0),        # R below 32
    (128, 48, 0),      # R no multiple of 32
    (128, 66, 0),      # R no multiple of 4
])
def test_cp_features_slice_width(G, R, want):
    width = cp_features_slice_width(G, R, 786432)
    assert width == want
    assert width in (0, 32, 64, 128)
    if width:
        assert R % width == 0 and 3 * G * width * 2 <= SHARED_BYTES
        # nothing wider that divides R would fit
        for wider in (64, 128):
            if wider > width and R % wider == 0:
                assert 3 * G * wider * 2 > SHARED_BYTES
    else:
        assert R % 32 or 3 * G * 32 * 2 > SHARED_BYTES


def test_cp_features_slice_width_follows_batch_and_budget():
    floor = cp_encoder.FEATURES_SHARED_MIN_BATCH
    # small batches read the tables from device memory
    assert cp_features_slice_width(128, 64, 1) == 0
    assert cp_features_slice_width(128, 64, floor - 1) == 0
    assert cp_features_slice_width(128, 64, floor) == 64
    assert cp_features_slice_width(512, 128, 131072) == 64
    assert cp_features_slice_width(512, 128, 131072, budget=100 * 1024) == 32
    assert cp_features_slice_width(512, 128, 131072, budget=48 * 1024) == 0
    assert cp_features_slice_width(128, 64, 131072, budget=48 * 1024) == 64


@pytest.mark.parametrize("G,R,B,want", [
    (128, 64, 786432, 64),   # the coarse flagship level whole: 144 KB
    (512, 128, 786432, 32),  # the fine one: four slices of 32, unstaged
    (256, 96, 70001, 32),    # 32 divides 96, 64 does not: staged
    (256, 64, 70001, 64),    # 64 unstaged is wider than 32 staged
    (128, 48, 70001, 16),    # R no multiple of 32
    (605, 64, 65536, 32),    # the largest G whose 32 features fit unstaged
    (606, 64, 65536, 16),    # then 16 staged
    (807, 16, 65536, 16),    # the largest G whose 16 features fit
    (808, 16, 65536, 0),
    (1024, 128, 786432, 0),  # tables beyond a block: global atomics
    (128, 40, 786432, 0),    # R no multiple of 16
    (128, 64, 65535, 0),     # a batch below the threshold
])
def test_cp_level_grads_slice_width(G, R, B, want):
    width = cp_level_grads_slice_width(G, R, B)
    assert width == want
    assert width in (0, 16, 32, 64)

    def fits(w):
        # f32 partial gradients of the slice, and the bf16 tables beside
        # them (any width) or not (32 and 64 only)
        return (3 * G * w * 6 <= SHARED_BYTES
                or (w >= 32 and 3 * G * w * 4 <= SHARED_BYTES))

    if width:
        assert R % width == 0 and fits(width)
        # staged wherever the tables fit beside the partial tables
        assert cp_level_grads_staged(G, width) == (
            3 * G * width * 6 <= SHARED_BYTES)
        # nothing wider that divides R would fit
        for wider in (32, 64):
            if wider > width and R % wider == 0:
                assert not fits(wider)


def test_cp_level_grads_slice_width_follows_batch_and_budget():
    floor = cp_encoder.GRADS_SHARED_MIN_BATCH
    assert cp_level_grads_slice_width(128, 64, 1) == 0
    assert cp_level_grads_slice_width(128, 64, floor - 1) == 0
    assert cp_level_grads_slice_width(128, 64, floor) == 64
    # 64 features fit unstaged (96 KB), not staged (144 KB)
    assert cp_level_grads_slice_width(128, 64, floor, budget=100 * 1024) == 64
    assert not cp_level_grads_staged(128, 64, budget=100 * 1024)
    assert cp_level_grads_slice_width(128, 64, floor, budget=90 * 1024) == 32
    assert cp_level_grads_slice_width(512, 128, floor, budget=48 * 1024) == 0


def test_zero_grads_is_one_allocation():
    grads, ptrs = cp_encoder._zero_grads(5, 7, torch.device("cpu"))
    assert len(grads) == 3 and len(ptrs) == 3
    for a, (d, ptr) in enumerate(zip(grads, ptrs)):
        assert d.shape == (5, 7) and d.dtype == torch.float32
        assert d.is_contiguous() and not bool(d.any())
        assert d.data_ptr() == ptr == ptrs[0] + a * 5 * 7 * 4
    grads[1].add_(1.0)  # the three are disjoint
    assert not bool(grads[0].any()) and not bool(grads[2].any())


class _FakeRuntime:
    """Stands in for the kernel library and for the three things
    ``_build.launch`` asks of ``torch.cuda``."""

    def __init__(self, monkeypatch, current=0, err=0):
        self.calls, self.entered, self.err = [], [], err
        runtime = self

        class Guard:
            def __init__(self, index):
                self.index = index

            def __enter__(self):
                runtime.entered.append(self.index)

            def __exit__(self, *exc):
                runtime.entered.append(("left", self.index))

        class Library:
            def __getattr__(self, symbol):
                runtime.lookups.append(symbol)
                return lambda *args: runtime.calls.append(
                    (symbol, args)) or runtime.err

            @staticmethod
            def nerfacc_error_string(err):
                return b"something failed"

        self.lookups = []
        monkeypatch.setattr(_build, "_functions", {})
        monkeypatch.setattr(_build, "lib", Library)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
        monkeypatch.setattr(torch.cuda, "device", Guard)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda index: 1000 + index, raising=False)


def test_launch_passes_the_stream_last_and_skips_the_guard(monkeypatch):
    rt = _FakeRuntime(monkeypatch, current=0)
    for _ in range(3):
        _build.launch("k", "nerfacc_k", torch.device("cuda", 0), 11, 22)
    assert rt.calls == [("nerfacc_k", (11, 22, 1000))] * 3
    assert rt.entered == []
    assert rt.lookups == ["nerfacc_k"]  # resolved once


def test_launch_resolves_a_device_without_index(monkeypatch):
    rt = _FakeRuntime(monkeypatch, current=2)
    _build.launch("k", "nerfacc_k", torch.device("cuda"), 5)
    assert rt.calls == [("nerfacc_k", (5, 1002))] and rt.entered == []


def test_launch_guards_a_device_that_is_not_current(monkeypatch):
    rt = _FakeRuntime(monkeypatch, current=1)
    _build.launch("k", "nerfacc_k", torch.device("cuda", 0), 7)
    # the other device's stream, taken inside the guard
    assert rt.calls == [("nerfacc_k", (7, 1000))]
    assert rt.entered == [0, ("left", 0)]


def test_launch_raises_on_a_cuda_error(monkeypatch):
    _FakeRuntime(monkeypatch, err=9)
    with pytest.raises(RuntimeError, match="k: CUDA error 9: something"):
        _build.launch("k", "nerfacc_k", torch.device("cuda", 0))


def test_cuda_ptr_refuses_what_a_kernel_does_not_take():
    t = torch.zeros((4, 3))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="must be on"):
        _build.cuda_ptr("k", "t", t, torch.float32, (4, 3), cpu)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="must be on"):
        _build.cuda_ptr("k", "t", meta, torch.float32, (4, 3),
                        torch.device("cuda", 0))


@pytest.mark.parametrize("N", [0, 1, 5])
def test_table_gather_on_cpu_tensors(N):
    rng = np.random.RandomState(N)
    table = torch.as_tensor(rng.randint(0, 2 ** 31, 64).astype(np.int32))
    idx_np = rng.randint(0, 64, N + 1).astype(np.int32)
    store = torch.as_tensor(idx_np)
    before = table_gather.launches
    for idx, want in ((store[:N], idx_np[:N]), (store[1:], idx_np[1:])):
        got = table_gather(idx, table)
        assert got.dtype == torch.int32 and got.shape == idx.shape
        np.testing.assert_array_equal(got.numpy(), table.numpy()[want])
        assert torch.equal(got, table_gather_plain(idx, table))
    assert table_gather.launches == before  # no kernel on the CPU
