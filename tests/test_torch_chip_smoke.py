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


@pytest.mark.parametrize("width", [(16, 128, 3), (8, 64, 69), (4, 32, 27)],
                         ids=["F16-H128-VD3", "F8-H64-VD69", "F4-H32-VD27"])
@pytest.mark.parametrize("kind", ["train", "eikonal"])
def test_kernel_check_at_other_widths(kind, width):
    """At the tiled form's widths the check reads F, H and VD off the
    arguments (``widths``), splits the decoder gradient at F + VD inputs and
    H units, accepts the plain outputs and fails on one wrong dW1 entry; the
    bound counts that decode's operations."""
    Fw, Hw, vd = width
    make = chip_smoke.synthetic_train_args if kind == "train" else chip_smoke.synthetic_eik_args
    plain = tk.train_iter_plain if kind == "train" else tk.eikonal_iter_plain
    args = make(False, 40, 6, 3, device="cpu", vd=vd, F=Fw, H=Hw)
    assert chip_smoke.widths(args) == (Fw, Hw, vd, 6)
    out = plain(*args)
    err, _ = chip_smoke._cmp(out, plain, args, kind)
    assert err == 0.0 and out[1].shape[-1] == Fw + 1
    bad = tuple(t.clone() for t in out)
    bad[2][(Fw + vd) * Hw - 1] += 1e-3 * bad[2].abs().max()
    with pytest.raises(SystemExit, match="dW1"):
        chip_smoke._cmp(bad, plain, args, kind)
    IN = Fw + vd
    assert chip_smoke.decode_flops(Fw, Hw, vd) == 4 * IN * Hw + 7 * Hw + 2 * Fw * Hw


def _flip_case():
    """One decode whose pre-activation is 0 in float32 and 2^-30 in float64:
    x = (1, 2^-30), W1 = (1, 1), b1 = -1 (F = VD = H = 1, B = k = 1)."""
    feats = torch.tensor([[[1.0, 0.0]]])
    params = torch.tensor([1.0, 1.0, -1.0, 0.5, 0.0])      # W1 (2, 1) | b1 | W2 | b2
    return (feats, torch.ones(1, 1), torch.tensor([[2.0 ** -30]]), torch.tensor([0.3]),
            torch.ones(1), params, True, 0.055, 0.1)


def test_kernel_check_takes_the_float32_masks_on_a_flip():
    """A pre-activation within float32 rounding of 0 takes the other side of
    the ReLU in float64: the float32 plain version itself is then far from
    the float64 one, and the check holds the part again to the float64
    version with the float32 masks (one flip) at the same tolerance; a
    wrong part still fails."""
    args = _flip_case()
    plain = tk.train_iter_plain
    out = plain(*args)
    assert float(out[1][0, 0, 0]) == 0.0                   # float32: the unit is off
    err, detail = chip_smoke._cmp(out, plain, args, "flip")
    assert err == 0.0 and detail["mask_flips"] == 1
    e_k, e_p, scale, e_a = detail["dfeats"]
    assert e_k == e_p > chip_smoke.TOL_REL * scale and e_a == 0.0
    bad = (out[0], out[1].clone(), out[2])
    bad[1][0, 0, 0] = 1e-3
    with pytest.raises(SystemExit, match="dfeats"):
        chip_smoke._cmp(bad, plain, args, "flip")


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


@pytest.mark.parametrize("kind", ["train", "eikonal"])
def test_identity_check_accepts_equal_and_fails_on_one_ulp(kind):
    """The two-launch check of the eikonal kernel (and the scatter): equal
    outputs pass, one value one ulp off in any output fails."""
    plain, args = _case(kind, False)
    out = plain(*args)
    chip_smoke.identical_check(out, tuple(t.clone() for t in out), kind)
    for i in range(3):
        bad = [t.clone() for t in out]
        flat = bad[i].view(-1)
        flat[-1] = torch.nextafter(flat[-1], torch.tensor(float("inf")))
        with pytest.raises(SystemExit, match="FAILED"):
            chip_smoke.identical_check(out, tuple(bad), kind)


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_dyadic_eikonal_inputs_make_preactivations_exact(wf):
    """The edge cases' inputs: every hidden pre-activation of every stencil
    decode is the same in float32 and float64, so no ReLU mask can flip
    between the kernel and the float64 check."""
    from pin_slam_torch.models.decoder import unpack

    n, k = 37, 16
    feats, wst, vst, _, params, _, _, _ = chip_smoke.synthetic_eik_args(
        wf, n, k, 3, device="cpu", dyadic=True)

    def pre(dt):
        W1, b1, _, _ = unpack(params.to(dt), IN, H)
        f, w3 = feats[..., :F].to(dt), wst.to(dt).reshape(6, n, k)
        if wf:
            x = torch.cat([torch.einsum("jnk,nkf->jnf", w3, f), vst.to(dt).reshape(6, n, 3)], -1)
        else:
            x = torch.cat([f[None].expand(6, n, k, F), vst.to(dt).reshape(6, n, k, 3)], -1)
        return x @ W1 + b1

    assert torch.equal(pre(torch.float32).double(), pre(torch.float64))


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_dyadic_train_inputs_make_preactivations_exact(wf):
    """The train edge cases' inputs: every hidden pre-activation of every
    decode is the same in float32 and float64."""
    from pin_slam_torch.models.decoder import unpack

    B, k = 37, 16
    feats, w, vin, _, _, params, _, _, _ = chip_smoke.synthetic_train_args(
        wf, B, k, 3, device="cpu", dyadic=True)

    def pre(dt):
        W1, b1, _, _ = unpack(params.to(dt), IN, H)
        f = feats[..., :F].to(dt)
        if wf:
            x = torch.cat([torch.einsum("bk,bkf->bf", w.to(dt), f), vin.to(dt)], -1)
        else:
            x = torch.cat([f, vin.to(dt).reshape(B, k, 3)], -1)
        return x @ W1 + b1

    assert torch.equal(pre(torch.float32).double(), pre(torch.float64))


def test_train_identity_check_fails_on_one_ulp(monkeypatch):
    """The train phase's two-launch check: a second launch one ulp off in any
    output fails it, equal launches pass."""
    plain, args = _case("train", True)
    out = plain(*args)
    for i in (None, 0, 1, 2):
        bad = [t.clone() for t in out]
        if i is not None:
            flat = bad[i].view(-1)
            flat[0] = torch.nextafter(flat[0], torch.tensor(float("inf")))
        calls = iter([out, tuple(bad)])
        monkeypatch.setattr(tk, "train_iter", lambda *a: next(calls))
        if i is None:
            assert chip_smoke.launched_twice(lambda *a: tk.train_iter(*a), args, "train") is out
        else:
            with pytest.raises(SystemExit, match="FAILED"):
                chip_smoke.launched_twice(lambda *a: tk.train_iter(*a), args, "train")


def test_identity_check_tells_signed_zeros_apart():
    chip_smoke.identical_check(torch.zeros(3), torch.zeros(3), "zeros")
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.identical_check(torch.zeros(3), -torch.zeros(3), "zeros")


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


def _rank_brick_args():
    """probe_rank_brick's arguments on a small random brick-layout table."""
    from pin_slam_torch.models import neural_points as npts

    g = torch.Generator().manual_seed(4)
    L, Hb, G, n = 512, 256, 40, 4
    pts = torch.floor((torch.rand(L + 1, 3, generator=g) * 8 - 4) * 8) / 8
    mc = npts.MapConfig(capacity=1 << 12, local_capacity=L, hash_size=1 << 10,
                        voxel_size=0.4, feature_dim=8, nn_k=6, max_valid_dist2=1.0,
                        local_map_radius=10.0, travel_dist_window=50.0,
                        local_hash_size=4 * Hb, brick=(2, 2, 1))
    table = npts._pack_hash_rows(mc, pts, torch.tensor(L), torch.arange(L + 1))
    tmpl = npts.make_probe_template(mc, 2, 0.2)
    probe = pts[:G] + 0.05
    q = probe[:, None, :] + torch.rand(G, n, 3, generator=g) * 0.4 - 0.2
    return mc, tmpl, (table, tmpl.bricks, tmpl.memb, probe, q, 6, L, mc.max_valid_dist2,
                      mc.voxel_size, mc.brick, mc.brick_rows)


@pytest.mark.parametrize("part", [0, 1, 2], ids=["gidx", "pos", "valid"])
def test_rank_check_accepts_twin_and_fails_on_one_value(part):
    from pin_slam_torch.ops import rank_kernel as rk

    _, _, args = _rank_brick_args()
    out = rk.probe_rank_brick_plain(*args)
    assert out[2].any() and not out[2].all()
    chip_smoke.rank_check(rk.probe_rank_brick(*args), out, "cpu")
    bad = [t.clone() for t in out]
    if part == 0:
        bad[0][3, 1, 2] += 1
    elif part == 1:
        bad[1][5, 0, 4, 1] = torch.nextafter(bad[1][5, 0, 4, 1], torch.tensor(float("inf")))
    else:
        bad[2][7, 2, 0] = ~bad[2][7, 2, 0]
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.rank_check(tuple(bad), out, "cpu")


def test_capture_tallies_and_keeps_the_fused_rank_inputs():
    """The capture wraps probe_rank_brick (what the mapper's brick path
    calls): calls alternate near / far, are tallied while the path is timed
    and cloned while capturing; calls of its plain twin are counted apart;
    uninstall puts every wrapper back."""
    from pin_slam_torch.ops import rank_kernel as rk
    from pin_slam_torch.slam import mapper as mp

    mc, tmpl, args = _rank_brick_args()
    orig = (rk.probe_rank_brick, rk.probe_rank_brick_plain)
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "X"
        lm = type("LM", (), {"hash_rows": args[0]})()
        out = mp._probe_rank(lm, mc, tmpl, args[3], args[4], 6)
        rk.probe_rank_brick(*args)
        cap.capturing = True
        rk.probe_rank_brick(*args)
    finally:
        cap.uninstall()
    assert (rk.probe_rank_brick, rk.probe_rank_brick_plain) == orig
    assert cap.tally == {("X", "rank_brick", "near"): 1, ("X", "rank_brick", "far"): 1}
    kept, _ = cap.inputs[("X", "rank_brick", "near")]
    assert kept[0] is not args[0] and torch.equal(kept[0], args[0]) and kept[5:] == list(args[5:])
    # on the CPU each wrapper call ran the plain twin once
    assert cap.plain_rank_calls == 3
    chip_smoke.rank_check(out, rk.probe_rank_brick_plain(*args), "cpu")


def test_rank_bound_counts_the_brick_rows_once():
    """The fused rank's bound reads each distinct table row that its groups
    hash to once (counted here from the plain gather of a table whose x
    fields hold their brick row's index), the probes, the template and the
    queries, and writes 17 bytes a neighbour, at 3.35 TB/s; its
    ``rows_fm_bound_ms`` charges every group its own Kc columns, as the
    bound of gathered rows does."""
    from pin_slam_torch.models import neural_points as npts

    mc, _, args = _rank_brick_args()
    table, bricks, memb, probe, q, k = args[:6]
    G, n, nsub, Kb = q.shape[0], q.shape[1], bricks.shape[0], bricks.shape[1]
    tagged = table.clone()
    tagged[:, 0] = torch.arange(table.shape[0] // nsub).repeat_interleave(nsub).float()
    rows_fm = npts.gather_brick_rows_fm(tagged, bricks, memb, probe, mc.voxel_size, mc.brick,
                                        mc.brick_rows, mc.local_capacity)
    distinct = torch.unique(rows_fm[:, :Kb * nsub]).numel()
    b, by, rows_fm_b, counted = chip_smoke.rank_brick_bounds(args)
    assert counted == distinct < G * Kb
    nbytes = (4 * (5 * nsub * distinct + 3 * G + bricks.numel() + memb.numel() + 3 * G * n)
              + 17 * G * n * k)
    assert by == "bytes" and b == pytest.approx(nbytes / 3.35e12 * 1e3)
    gathered, _ = chip_smoke.rank_bound(G, n, Kb * nsub, k)
    assert rows_fm_b == pytest.approx(gathered + 12 * G / 3.35e12 * 1e3) and b < rows_fm_b


@pytest.mark.parametrize("form", ["zero_base", "table"])
def test_ordered_check_accepts_the_in_order_sum_and_fails_on_one_ulp(form):
    """The scatter phases' bit check: both forms (their plain versions on
    the CPU) pass against scatter_add_rows_ordered; one element one ulp off
    fails it."""
    rows, table, idx, val, sentinel = _row_case()
    base = torch.zeros_like(table) if form == "zero_base" else table
    out, err, ratio = chip_smoke.scatter_forms(table.shape[0], idx, val, None, sentinel, table,
                                               "cpu")
    assert torch.equal(out, rows.scatter_add_rows_plain(torch.zeros_like(table), idx, val,
                                                        sentinel))
    assert ratio <= 1.0
    ref = rows.scatter_add_rows_ordered(base, idx, val, sentinel)
    got = rows.scatter_add_rows_plain(base, idx, val, sentinel)
    chip_smoke.ordered_check(got, ref, form)
    bad = got.clone()
    bad[int(idx[1]), 4] = torch.nextafter(bad[int(idx[1]), 4], torch.tensor(float("inf")))
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.ordered_check(bad, ref, form)


def test_ordered_check_tells_signed_zeros_apart():
    chip_smoke.ordered_check(torch.zeros(3, 2), torch.zeros(3, 2), "zeros")
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.ordered_check(torch.zeros(3, 2), -torch.zeros(3, 2), "zeros")


def test_scatter_bounds_count_what_each_form_reads():
    """The zero-base bound reads the value rows and int32 order entries that
    are not skipped, the int32 offsets and writes the sums; the table bound
    is the int64-plan kernel's count: table, int64 indices and every value read,
    the table written.  At path A's shape with no sentinel terms: ~6.95 MB
    and ~9.47 MB at 3.35 TB/s."""
    N, C, M = (1 << 16) + 1, 9, 108132
    idx = torch.zeros(M, dtype=torch.int64)
    idx[:1000] = N - 1
    b, by, tb = chip_smoke.scatter_bounds(N, C, idx, None)
    assert by == "bytes"
    assert b == pytest.approx(4 * (M * C + M + N + 1 + N * C) / 3.35e12 * 1e3)
    assert tb == pytest.approx((4 * (2 * N * C + M * C) + 8 * M) / 3.35e12 * 1e3)
    assert 6.9e6 < 4 * (M * C + M + N + 1 + N * C) < 7.0e6
    skipped, _, tb2 = chip_smoke.scatter_bounds(N, C, idx, N - 1)
    assert skipped == pytest.approx(b - 4 * 1000 * (C + 1) / 3.35e12 * 1e3) and tb2 == tb


def test_capture_keeps_the_zero_base_scatter_and_the_frame_plans():
    """The capture wraps what the mapper calls (scatter_sum_rows once an
    iteration, scatter_plans once a training call), tallies and clones, and
    uninstall puts both back."""
    rows, table, idx, val, sentinel = _row_case()
    orig = (rows.scatter_sum_rows, rows.scatter_plans)
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "X"
        plan = rows.scatter_plans(idx, table.shape[0])
        rows.scatter_sum_rows(table.shape[0], idx, val, plan=plan, skip_row=sentinel)
        cap.capturing = True
        out = rows.scatter_sum_rows(table.shape[0], idx, val, plan=plan, skip_row=sentinel)
    finally:
        cap.uninstall()
    assert (rows.scatter_sum_rows, rows.scatter_plans) == orig
    assert cap.tally == {("X", "plans", "frame"): 1, ("X", "scatter", "main"): 1}
    (n, i, v), kw = cap.inputs[("X", "scatter", "main")]
    assert n == table.shape[0] and i is not idx and torch.equal(i, idx)
    assert kw["skip_row"] == sentinel and torch.equal(kw["plan"].order, plan.order)
    assert torch.equal(out, rows.scatter_add_rows_plain(torch.zeros_like(table), idx, val,
                                                        sentinel))


def test_capture_keeps_bundle_adjustment_rows_apart_and_stores_while_tallying():
    """Inside bundle adjustment (``in_ba``) the row kernels' calls are kind
    ``ba``; with ``store`` set they are tallied and cloned at once (path D
    keeps its last frame's and its first BA's inputs so, without an extra
    frame)."""
    rows, table, idx, val, sentinel = _row_case()
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "D"
        cap.in_ba, cap.store = True, True
        tab = table[:, :8].contiguous().requires_grad_(True)
        out = rows.GatherRowsFn.apply(tab, idx, sentinel)
        out.sum().backward()
        cap.in_ba, cap.store = False, False
        rows.scatter_sum_rows(table.shape[0], idx, val, skip_row=sentinel)
    finally:
        cap.uninstall()
    assert cap.tally == {("D", "gather", "ba"): 1, ("D", "scatter", "ba"): 1,
                         ("D", "scatter", "main"): 1}
    (t, i), _ = cap.inputs[("D", "gather", "ba")]
    assert t.shape == (table.shape[0], 8) and torch.equal(i, idx)
    (n, i, v), kw = cap.inputs[("D", "scatter", "ba")]
    assert n == table.shape[0] and v.shape == (idx.shape[0], 8) and kw["skip_row"] == sentinel
    assert ("D", "scatter", "main") not in cap.inputs


def test_snapshot_clone_is_deep_and_bits_compare_exactly():
    """Path D reruns its first bundle adjustment from ``_clone``d inputs:
    dataclasses and modules are copied, not shared; ``_bits_equal`` tells
    one ulp and signed zeros apart."""
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam import mapper as mp

    pool = mp.PoolState(rows=torch.ones(4, 3), head=torch.tensor(0), fill=torch.tensor(2),
                        new_idx=torch.zeros(2, dtype=torch.int64), new_count=torch.tensor(0))
    dec = Decoder(11, 8, 1, 1)
    c_pool, c_dec = chip_smoke._clone(pool), chip_smoke._clone(dec)
    pool.rows.add_(1.0)
    with torch.no_grad():
        dec.out.bias.add_(1.0)
    assert torch.equal(c_pool.rows, torch.ones(4, 3))
    assert not torch.equal(c_dec.out.bias, dec.out.bias)
    a = torch.tensor([0.0, 1.0])
    assert chip_smoke._bits_equal(a, a.clone())
    assert not chip_smoke._bits_equal(a, torch.tensor([-0.0, 1.0]))
    assert not chip_smoke._bits_equal(a, torch.nextafter(a, torch.tensor(2.0)))


def test_path_e_writer_matches_convert_replica(tmp_path, monkeypatch):
    """Path E's data writer (the RGB-D renderer -> converters.backproject_depth
    -> PLY + poses.txt, here at 64 x 36 pixels with Replica's intrinsics)
    writes the files ``converters.convert_replica`` writes from the same
    frames stored in Replica's own layout (16-bit depth PNG, the colour image
    stored losslessly under its .jpg name, traj.txt): byte for byte."""
    import functools

    import numpy as np
    from PIL import Image

    from pin_slam_torch.dataset import converters
    from pin_slam_torch.utils import synthetic as syn

    small = functools.partial(syn.render_rgbd, width=64, height=36)
    monkeypatch.setattr(syn, "render_rgbd", small)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setitem(chip_smoke.PATH_E, "n_frames", 3)
    seq, counts, _ = chip_smoke.write_path_e_data()
    assert counts == [32 * 18] * 3

    raw = tmp_path / "raw"
    os.makedirs(raw / "results")
    poses = [syn.rgbd_pose(i, 3) for i in range(3)]
    for i, T in enumerate(poses):
        depth, color = small(T)
        assert depth.dtype == np.uint16 and color.dtype == np.uint8 and depth.min() > 0
        Image.fromarray(depth).save(raw / "results" / f"depth{i:06d}.png")
        Image.fromarray(color).save(raw / "results" / f"frame{i:06d}.jpg", format="PNG")
    np.savetxt(raw / "traj.txt", np.stack(poses).reshape(3, 16))
    out = tmp_path / "converted"
    assert converters.convert_replica(str(raw), str(out)) == 3
    names = sorted(os.listdir(os.path.join(seq, "rgbd_ply")))
    assert names == sorted(os.listdir(out / "rgbd_ply")) and len(names) == 3
    for rel in [os.path.join("rgbd_ply", n) for n in names] + ["poses.txt"]:
        with open(os.path.join(seq, rel), "rb") as a, open(out / rel, "rb") as b:
            assert a.read() == b.read(), rel


def test_capture_tells_the_colour_rows_apart():
    """The training loop's colour rows are their own kinds: the colour
    features' gather (8 columns) and the colour labels' gather (3) outside
    bundle adjustment, the colour gradient's scatter (8 columns)."""
    rows, table, idx, val, sentinel = _row_case()
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "E"
        rows.gather_rows(table[:, :8].contiguous(), idx)
        rows.gather_rows(table[:, :3].contiguous(), idx)
        rows.gather_rows(table, idx)
        rows.scatter_sum_rows(table.shape[0], idx, val[:, :8].contiguous(), skip_row=sentinel)
        rows.scatter_sum_rows(table.shape[0], idx, val, skip_row=sentinel)
        cap.in_ba = True
        rows.gather_rows(table[:, :8].contiguous(), idx)
    finally:
        cap.uninstall()
    assert cap.tally == {("E", "gather", "color"): 1, ("E", "gather", "label"): 1,
                         ("E", "gather", "feat"): 1, ("E", "scatter", "color"): 1,
                         ("E", "scatter", "main"): 1, ("E", "gather", "ba"): 1}


def _small_path_f(monkeypatch, tmp_path, n_frames=2):
    import functools

    from pin_slam_torch.utils import synthetic as syn

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setitem(chip_smoke.PATH_F, "n_frames", n_frames)
    monkeypatch.setitem(chip_smoke.PATH_F, "n_points", 3000)
    monkeypatch.setitem(chip_smoke.PATH_F, "density", 0.3)
    monkeypatch.setattr(syn, "labelled_corridor_scans",
                        functools.partial(syn.labelled_corridor_scans, n_az=400, n_el=48))
    return chip_smoke.write_path_f_data()


def test_path_f_data_reads_in_both_packages(tmp_path, monkeypatch):
    """Path F's sequence (here 2 small sweeps): both packages' datasets read
    it with the profile's intrinsic correction and give the same points and
    learning classes; the correction gives back the scene's points (its
    inverse was applied on writing); the ground truth through calib.txt is
    the scene's; the person (raw 254) is dropped."""
    import numpy as np

    import jax

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset

    jax.config.update("jax_platforms", "cpu")
    seq, labels, poses, _, n_points, _ = _small_path_f(monkeypatch, tmp_path)
    assert n_points == [3000, 3000]
    ds = []
    for Config, Dataset in ((JConfig, JDataset), (TConfig, TDataset)):
        cfg = Config()
        cfg.load(os.path.join(ROOT, chip_smoke.PATH_F["profile"]))
        cfg.pc_path, cfg.label_path = f"{seq}/velodyne", f"{seq}/labels"
        cfg.pose_path, cfg.calib_path = f"{seq}/poses.txt", f"{seq}/calib.txt"
        cfg.semantic_on = True
        assert cfg.kitti_correction_on and cfg.filter_moving_object
        ds.append(Dataset(cfg))
    jp, _, js, _ = ds[0].read_frame(1)
    tp, _, _, ts_ = ds[1].read_frame(1)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts_, js)
    assert 6 not in set(ts_.tolist()) and {9, 13} <= set(ts_.tolist())
    assert np.abs(ds[1].gt_poses - poses).max() < 1e-9
    scans, raw, _, _ = syn.labelled_corridor_scans(chip_smoke.PATH_F["seed"], 2, 3000,
                                                   density=0.3)
    keep = raw[1] != syn.RAW_PERSON
    from pin_slam_torch.dataset.slam_dataset import intrinsic_correct

    np.testing.assert_allclose(intrinsic_correct(tp, 0.195), scans[1][keep, :3], atol=1e-4)


def test_path_f_profile_keys_reach_both_loaders(tmp_path):
    """The YAML section path F writes each option into is one both
    packages' loaders read it from."""
    import yaml

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_tpu.config import Config as JConfig

    with open(os.path.join(ROOT, chip_smoke.PATH_F["profile"])) as f:
        prof = yaml.safe_load(f)
    for key in ("semantic_on", "dynamic_filter_on", "estimate_normal"):
        prof.setdefault(chip_smoke._section_of(key), {})[key] = True
    path = str(tmp_path / "p.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(prof, f)
    for Config in (JConfig, TConfig):
        cfg = Config().load(path)
        assert all(getattr(cfg, k) for k in chip_smoke.F_OPTIONS), Config


def test_path_f_scene_reference_classes(monkeypatch):
    """The surfaces path F holds the mesh's classes to: road, building,
    pole and the car at each frame's place, never the person."""
    import numpy as np

    from pin_slam_torch.utils import synthetic as syn

    world = syn.labelled_corridor_world(np.random.default_rng(0), density=0.2)
    monkeypatch.setitem(chip_smoke.PATH_F, "density", 0.2)
    pts, cls = chip_smoke._scene_reference(world, syn.CAR_ENTER + 2)
    assert set(np.unique(cls).tolist()) == {1, 9, 13, 18}
    assert pts.shape == (cls.shape[0], 3) and (cls == 1).sum() > 100


def test_capture_tallies_the_autograd_loop_rows():
    """On path F the autograd loop's rows are the main kinds: the pool rows'
    gather once a call, the feature rows' gather (9 columns) and their
    gradient's scatter once an iteration, the plans once a call."""
    import numpy as np

    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam import mapper as tm
    from torch_port_util import small_config

    from pin_slam_torch.config import Config

    cfg = small_config(Config, semantic_on=True, bs=64, bs_new_sample=8, pool_capacity=1 << 10)
    mc, mcfg = tn.MapConfig.from_config(cfg), tm.MapperConfig.from_config(cfg)
    rng = np.random.default_rng(0)
    st = tn.init_map_state(mc)
    pts = torch.as_tensor(rng.uniform(-3, 3, (500, 3)).astype(np.float32))
    travel = torch.zeros(64)
    st = tn.map_insert(st, mc, pts, torch.ones(500, dtype=torch.bool), 0, travel,
                       downsample_table_size=cfg.downsample_hash_size, insert_bucket=512)
    lm = tn.build_local_map(st, mc, torch.zeros(3), 0, travel)
    pool = tm.init_pool(mcfg)
    n = 140
    gidx = torch.as_tensor(rng.integers(-1, int(st.count), (n, 6)).astype(np.int32))
    pool = tm.pool_append(pool, mcfg, pts[:n], pts[:n], torch.zeros(n), torch.ones(n),
                          torch.ones(n, dtype=torch.bool), 0, torch.ones(n, dtype=torch.bool),
                          gidx, torch.full((n, 6), 1 / 6), torch.zeros(n, 3),
                          knn_nbr_vec=torch.zeros(n, 6, 3),
                          sem_label=torch.as_tensor(rng.integers(0, 20, n)))
    g = torch.Generator().manual_seed(0)
    geo = Decoder(11, 16, 1, 1, generator=g)
    sem = Decoder(11, 16, 1, 20, generator=g)
    heads = tm.init_heads(geo, sem)
    feats = torch.zeros(mc.local_capacity + 1, 9)
    idx = tm.sample_batch_indices(g, pool, mcfg, torch.tensor(True), 3)
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "F"
        tm.mapping_loop_autograd(lm, mc, feats, heads, tm.init_opt_state(feats, heads), pool,
                                 mcfg, idx, 1.0)
    finally:
        cap.uninstall()
    assert cap.tally == {("F", "gather", "pool"): 1, ("F", "gather", "feat"): 3,
                         ("F", "scatter", "main"): 3, ("F", "plans", "frame"): 1}


def test_capture_tallies_the_colour_rows_of_the_autograd_loop():
    """Egen's rows: with the colour head the autograd loop adds the colour
    labels' gather once a call (3 columns), the colour rows' gather (8) and
    their gradient's scatter once an iteration, told apart from the feature
    rows (9)."""
    import numpy as np

    from pin_slam_torch.config import Config
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam import mapper as tm
    from torch_port_util import small_config

    cfg = small_config(Config, color_on=True, color_channel=3, geo_mlp_level=2, bs=64,
                       bs_new_sample=8, pool_capacity=1 << 10)
    mc, mcfg = tn.MapConfig.from_config(cfg), tm.MapperConfig.from_config(cfg)
    rng = np.random.default_rng(0)
    st = tn.init_map_state(mc)
    pts = torch.as_tensor(rng.uniform(-3, 3, (500, 3)).astype(np.float32))
    travel = torch.zeros(64)
    st = tn.map_insert(st, mc, pts, torch.ones(500, dtype=torch.bool), 0, travel,
                       downsample_table_size=cfg.downsample_hash_size, insert_bucket=512)
    lm = tn.build_local_map(st, mc, torch.zeros(3), 0, travel)
    pool = tm.init_pool(mcfg, color_channel=3)
    n = 140
    gidx = torch.as_tensor(rng.integers(-1, int(st.count), (n, 6)).astype(np.int32))
    pool = tm.pool_append(pool, mcfg, pts[:n], pts[:n], torch.zeros(n), torch.ones(n),
                          torch.ones(n, dtype=torch.bool), 0, torch.ones(n, dtype=torch.bool),
                          gidx, torch.full((n, 6), 1 / 6), torch.zeros(n, 3),
                          color_label=torch.rand(n, 3))
    g = torch.Generator().manual_seed(0)
    heads = tm.init_heads(Decoder(11, 16, 2, 1, generator=g))
    color = tm.init_color_state(torch.zeros(mc.local_capacity + 1, 8),
                                Decoder(11, 16, 1, 3, generator=g))
    feats = torch.zeros(mc.local_capacity + 1, 9)
    idx = tm.sample_batch_indices(g, pool, mcfg, torch.tensor(True), 3)
    cap = chip_smoke.Capture()
    cap.install()
    try:
        cap.path = "Egen"
        tm.mapping_loop_autograd(lm, mc, feats, heads, tm.init_opt_state(feats, heads), pool,
                                 mcfg, idx, 1.0, color=color)
    finally:
        cap.uninstall()
    assert cap.tally == {("Egen", "gather", "pool"): 1, ("Egen", "gather", "label"): 1,
                         ("Egen", "gather", "feat"): 3, ("Egen", "gather", "color"): 3,
                         ("Egen", "scatter", "main"): 3, ("Egen", "scatter", "color"): 3,
                         ("Egen", "plans", "frame"): 1}


def test_np_cloud_size_follows_the_ladder():
    ladder = [11, 23, 37]
    assert chip_smoke.np_cloud_size(0, ladder) == 0
    assert chip_smoke.np_cloud_size(12, ladder) == 2                 # rows 0 and 11
    assert chip_smoke.np_cloud_size(499_999, ladder) == 45455
    assert chip_smoke.np_cloud_size(500_000, ladder) == 21740        # the second rung
    assert chip_smoke.np_cloud_size(5_000_000, ladder) == 135136     # the last rung holds


@pytest.fixture
def ros_node(tmp_path, monkeypatch):
    """The port's node on the CPU under chip_smoke's own fakes, two frames in."""
    import numpy as np

    from pin_slam_torch.config import Config

    mods, rec = chip_smoke.ros_fakes()
    for name, m in mods.items():
        monkeypatch.setitem(sys.modules, name, m)
    from pin_slam_torch.ros import PinSlamRosNode

    cfg = Config()
    cfg.min_range, cfg.max_range = 0.5, 20.0
    cfg.bs, cfg.iters, cfg.init_iter_ratio, cfg.reg_iter_n = 1024, 3, 2, 20
    cfg.map_capacity, cfg.local_map_capacity = 1 << 14, 1 << 12
    cfg.buffer_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, 1 << 12, 1 << 10
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 14, 1 << 15
    cfg.silence = True
    cfg._derive()
    cfg.output_root = str(tmp_path)
    node = PinSlamRosNode(cfg, cloud_topic="/points", device="cpu")
    rng = np.random.default_rng(0)
    counts = []
    for f in range(2):
        d = rng.normal(size=(4000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts = (d * (5.0 / np.abs(d).max(1))[:, None] + [0.02 * f, 0, 0]).astype(np.float32)
        rec.subscribers["/points"](mods["sensor_msgs.msg"].PointCloud2(pts))
        counts.append(int(node.slam.system.state.count))
    return node, rec, counts


def test_ros_publish_check_accepts_the_node_and_fails_on_a_missing_message(ros_node):
    node, rec, counts = ros_node
    ladder = node.cfg.publish_np_map_down_rate_list
    chip_smoke.ros_publish_check(rec.pubs, len(node.tf_broadcaster.sent), counts, ladder)
    with pytest.raises(SystemExit, match="TF"):
        chip_smoke.ros_publish_check(rec.pubs, 1, counts, ladder)
    with pytest.raises(SystemExit, match="neural-point clouds"):
        chip_smoke.ros_publish_check(rec.pubs, 2, [counts[0], counts[1] + 11], ladder)
    rec.pubs["~odometry"].msgs.pop()
    with pytest.raises(SystemExit, match="messages"):
        chip_smoke.ros_publish_check(rec.pubs, 2, counts, ladder)


def test_grid_share_tells_the_marching_spacing_apart():
    """A sphere meshed at 0.25 m has about 0.8 of its vertices on a plane of
    its grid and few on one of a 0.4 m grid (the two share every eighth
    0.25 m plane), and the other way round: live_C's retune gate (> 0.6 on
    the new grid, < 0.4 on the old)."""
    import numpy as np

    from pin_slam_torch.ops.marching_cubes import marching_tetrahedra

    def sphere(res):
        ax = np.arange(-12, 13) * res
        g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
        v, _ = marching_tetrahedra(np.linalg.norm(g, axis=-1) - 2.0, origin=(ax[0],) * 3,
                                   spacing=res, use_native=False)
        return v

    v25, v40 = sphere(0.25), sphere(0.4)
    assert len(v25) > 500
    assert chip_smoke.grid_share(v25, 0.25) > 0.6 and chip_smoke.grid_share(v25, 0.4) < 0.4
    assert chip_smoke.grid_share(v40, 0.4) > 0.6 and chip_smoke.grid_share(v40, 0.25) < 0.4
    assert chip_smoke.grid_share(np.zeros((0, 3)), 0.25) == 0.0


def test_mesh_stats_and_extent_ratio(tmp_path):
    import numpy as np

    from pin_slam_torch.dataset import io as pio

    pts = np.array([[0, 0, 0], [10, 4, 1]], np.float32)
    verts = np.array([[1, 0, 0], [9, 4, 0], [5, 2, 2]], np.float32)
    assert chip_smoke.xy_extent_ratio(verts, pts) == pytest.approx(0.8)
    path = str(tmp_path / "m.ply")
    assert chip_smoke.mesh_file_stats(path) == (0, False)
    pio.write_ply(path, verts, faces=np.array([[0, 1, 2]], np.int64))
    assert chip_smoke.mesh_file_stats(path) == (3, True)
    pio.write_ply(path, np.array([[0, 0, np.nan]] * 3, np.float32),
                  faces=np.array([[0, 1, 2]], np.int64))
    assert chip_smoke.mesh_file_stats(path) == (3, False)
