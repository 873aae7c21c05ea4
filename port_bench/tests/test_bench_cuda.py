"""The harness on the card at the tests' sizes: every cell's run reads
correct through the program's CUDA kernels, and the control fails the
limits there too. Skips without a CUDA card (decided inside the test).

    python -m pytest -p no:cacheprovider port_bench/tests/test_bench_cuda.py
"""

import pytest
import torch

from port_bench import run as bench_run
from port_bench.harness import compare, train, view
from port_bench.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("workload,runner", [
    ("instant_ngp.train", train), ("vanilla_nerf.train", train),
    ("instant_ngp.view", view)])
def test_cells_on_the_card(workload, runner, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    small.use_small_grid(monkeypatch)
    cell = small.small_cell(workload)
    out = bench_run.run(workload, 8, 0.5, True, dev, cell=cell)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]
    d = runner.Cell(cell, 9, dev)
    d.setup()
    d.window(0.2, spans=False)
    d.free()
    bounds = compare.limits(workload)
    del bounds["matmul_tf32"]  # read by ``run.run`` from PyTorch's flags
    with compare.reference_precision():
        numbers = d.check("control")
    assert not compare.verdict({k: numbers[k] for k in bounds}, bounds)[0]
