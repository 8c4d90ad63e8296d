"""The runner on the card at a small copy of each cell's traffic: the
program's kernels, judged as a run judges them.  Skips without a card;
on the card: ``python -m pytest -m gpu portbench/tests``."""

import numpy as np
import pytest

from portbench import run

SMALL = {
    "nw_blosum62.h3n2_all": {"limit": 300},
    "mh_k4_n50.h3n2ha_all": {"limit": 2000},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_is_correct_on_the_card(card, cell):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w, config, traffic = run.find_cell(bench, cell)
    result, r, judged = run.measure(w, config, {**traffic, **SMALL[cell]},
                                    2**31 + 99, 1.0, True, card)
    assert result["correct"], judged
    assert result["device"]["busy_s"] > 0
    assert r.trace.kernel_s > 0 and np.isfinite(r.setup_s)
