"""``odometry_torch.tools.kernel_parity`` on the CPU: its cases are
``tools/tpu_parity.py``'s at that tool's sizes, its tie check tells ties
from real flips, and it refuses to run without a card (there is no
interpreter for a CUDA kernel to fall back to). The cases themselves run on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from odometry_torch.data.synthetic import tie_stereo_pair
from odometry_torch.tools import kernel_parity as kp

REPO = Path(__file__).resolve().parents[1]


def _tpu_parity():
    spec = importlib.util.spec_from_file_location("tpu_parity", REPO / "tools" / "tpu_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["band", "full", "dense"])
def test_case_sizes_are_tpu_paritys(case):
    ref = inspect.signature(_tpu_parity().CASES[case]).parameters["sizes"].default
    ours = inspect.signature(kp.CASES[case]).parameters["sizes"].default
    assert ours == ref


def test_cases_keep_every_check_of_the_smoke_script():
    # The cases chip_smoke.py held before they moved here, none dropped.
    assert len(kp.SELECTED_CASES) == 10 and len(kp.SELECTED_LR_CASES) == 1
    assert len(kp.DENSE_CASES) == 4 and len(kp.SECOND_CASES) == 2
    assert len(kp.TIE_CASES) == 11 and kp.BAND_EQUAL_SEEDS == (0, 7)
    assert len(kp.WIDE_CASES) == 3 and len(kp.FORCED_TILED_CASES) == 2
    assert (kp.TIE_ABS, kp.TIE_REL) == (0.5, 8 * 2.0**-24)
    assert (kp.MAX_FLIP_FRACTION_SELECTED, kp.MAX_FLIP_FRACTION_DENSE) == (0.005, 0.01)
    assert len(kp.BATCH_CASES) == 8
    assert set(kp.CASES) == {"band", "full", "dense", "selected", "winner_maps", "ties",
                             "tiled", "batched"}


def test_flips_are_ties_tells_ties_from_flips():
    # tie_stereo_pair: integer images whose SSDs repeat exactly every period.
    ls, rs = (torch.from_numpy(a) for a in tie_stereo_pair(16, 96, seed=3))
    pairs = kp._Pairs(ls, rs)
    y = torch.tensor([8])
    x = torch.tensor([60])
    a = torch.tensor([40])
    tied = torch.tensor([40 - 24])  # one period away: the same SSD
    assert float(pairs.ssd(y, x, a)) == float(pairs.ssd(y, x, tied))
    assert kp._flips_are_ties(pairs, y, (x, a), (x, tied))
    far = torch.tensor([45])
    assert float((pairs.ssd(y, x, a) - pairs.ssd(y, x, far)).abs()) > float(pairs.band(y, x, a))
    assert not kp._flips_are_ties(pairs, y, (x, a), (x, far))
    assert kp._flips_are_ties(pairs, torch.tensor([], dtype=torch.long), (x, a), (x, far))


def test_tpu_value_budget():
    best_p = torch.tensor([[100.0, 1e6]])
    region = torch.ones_like(best_p, dtype=torch.bool)
    ok = kp._tpu_value_ok(best_p + torch.tensor([[0.49, 1e6 * 512 * 2.0**-23]]), best_p,
                          region, 0.5)
    assert ok
    assert not kp._tpu_value_ok(best_p + torch.tensor([[0.6, 0.0]]), best_p, region, 0.5)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cases run in tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kp.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kp.run(["band"])
    with pytest.raises(SystemExit):
        kp.main(["--case", "interpret"])
