"""chip_smoke.py's check of a training kernel against its plain version, on
the CPU: it accepts the plain outputs themselves and fails when any one part
(loss, feature gradients, certainty column, one decoder-gradient leaf) is
wrong, even where that part is orders of magnitude smaller than the others,
as the feature gradients are at the main path's row weights (~1/B)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pin_slam_torch.ops import train_kernel as tk  # noqa: E402

torch.set_num_threads(1)
F, IN, H = tk.KERNEL_F, tk.KERNEL_F + tk.KERNEL_VD, tk.KERNEL_H
LEAF = {"dW1": 0, "db1": IN * H, "dW2": IN * H + H, "db2": IN * H + 2 * H}


def _case(kind, wf):
    if kind == "train":
        return tk.train_iter_plain, chip_smoke.synthetic_train_args(wf, 512, 6, 1, device="cpu")
    return tk.eikonal_iter_plain, chip_smoke.synthetic_eik_args(wf, 64, 6, 2, device="cpu")


def _corrupt(out, part):
    loss, dfeats, dparams = (t.clone() for t in out)
    if part == "loss":
        loss *= 1.01
    elif part == "dfeats":
        dfeats[..., :F] = 0.0
    elif part == "dfeats_one_value":
        dfeats[3, 2, 5] += 1e-3 * dfeats[..., :F].abs().max()
    elif part == "certainty":
        dfeats[..., F] *= 1.0001
    else:                          # one leaf off by 1e-3 of the decoder gradients' scale
        dparams[LEAF[part]] += 1e-3 * dparams.abs().max()
    return loss, dfeats, dparams


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
@pytest.mark.parametrize("kind", ["train", "eikonal"])
def test_kernel_check_accepts_plain_outputs(kind, wf):
    plain, args = _case(kind, wf)
    err, detail = chip_smoke._cmp(plain(*args), plain, args, kind)
    assert err == 0.0 and set(detail) == {"loss", "dfeats", "certainty", "dW1", "db1",
                                          "dW2", "db2"}


@pytest.mark.parametrize("part", ["loss", "dfeats", "dfeats_one_value", "certainty",
                                  "dW1", "db1", "dW2", "db2"])
@pytest.mark.parametrize("kind", ["train", "eikonal"])
def test_kernel_check_fails_on_a_wrong_part(kind, part):
    plain, args = _case(kind, True)
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke._cmp(_corrupt(plain(*args), part), plain, args, kind)


def _row_case():
    from pin_slam_torch.ops import rows

    g = torch.Generator().manual_seed(3)
    N, C, M = 513, 9, 4000
    table = torch.randn(N, C, generator=g)
    idx = torch.randint(0, N, (M,), generator=g)
    idx[torch.rand(M, generator=g) < 0.3] = N - 1        # the sentinel's long segment
    val = torch.randn(M, C, generator=g) * 1e-3
    return rows, table, idx, val, N - 1


def test_gather_check_accepts_twin_and_fails_on_one_wrong_row():
    rows, table, idx, _, _ = _row_case()
    out = rows.gather_rows_plain(table, idx)
    chip_smoke.gather_check(out, table, idx, "cpu")
    bad = out.clone()
    bad[7, 4] = torch.nextafter(bad[7, 4], torch.tensor(float("inf")))
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.gather_check(bad, table, idx, "cpu")


@pytest.mark.parametrize("skip", [True, False], ids=["skip_sentinel", "all_rows"])
def test_scatter_check_accepts_twin_and_fails_on_one_wrong_row(skip):
    rows, table, idx, val, sentinel = _row_case()
    skip_row = sentinel if skip else None
    out = rows.scatter_add_rows_plain(table, idx, val, skip_row)
    err, ratio = chip_smoke.scatter_check(out, table, idx, val, skip_row)
    assert ratio <= 1.0
    # one row off by a few hundred ulps of its magnitude
    row = int(idx[0])
    bad = out.clone()
    bad[row, 2] += 300 * 2.0 ** -23 * (abs(float(bad[row, 2])) + 1.0)
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.scatter_check(bad, table, idx, val, skip_row)
