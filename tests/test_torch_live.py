"""The port's live surfaces against the JAX package's on the CPU: the viewer
export (static and live, byte for byte, with the point decimation and the
data-pool layer), the sensor glyphs, the control channel of ``SlamSystem``
(pause / step / mesh now / pause at loop / the mesher's live retune, as
tests/test_viewer.py holds the JAX package's), the viewer server (POST
/control merged into control.json, bound to 127.0.0.1), and the in-run
artifacts of tests/test_periodic_vis.py's 5-frame sequence through both
packages.

Files and glyph arrays must be equal.  The in-run meshes come from maps
trained from the same synced state with the same random draws; training
amplifies float32 rounding (ROADMAP C 7), so the meshes are held to each
other within a stated distance: every vertex within 0.5 x mc_res_m of the
other mesh, in both directions, and vertex counts within 10 %."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _arrays(rng, n_pts):
    return dict(
        scan=rng.normal(size=(700, 3)).astype(np.float32),
        neural_points=rng.normal(size=(n_pts, 3)).astype(np.float32),
        mesh_verts=rng.normal(size=(30, 3)).astype(np.float32),
        mesh_faces=rng.integers(0, 30, size=(40, 3)).astype(np.uint32),
        mesh_colors=rng.uniform(0, 1, size=(30, 3)).astype(np.float32),
        trajectory=np.cumsum(rng.normal(size=(50, 3)), axis=0).astype(np.float32),
        sdf_slice_points=rng.normal(size=(200, 3)).astype(np.float32),
        sdf_slice_colors=rng.uniform(0, 1, size=(200, 3)).astype(np.float32),
        sensor_verts=rng.normal(size=(16, 3)).astype(np.float32),
        sensor_faces=rng.integers(0, 16, size=(20, 3)).astype(np.int64),
        pool_points=rng.normal(size=(300, 3)).astype(np.float32),
        pool_labels=(0.2 * rng.normal(size=300)).astype(np.float32))


# 1.6 M neural points pass the 1.5 M cap: the layer keeps every second one
@pytest.mark.parametrize("n_pts", [1000, 1_600_000], ids=["whole", "decimated"])
def test_export_html_static_is_byte_identical(tmp_path, n_pts):
    from pin_slam_torch.utils import viewer_html as tv
    from pin_slam_tpu.utils import viewer_html as jv

    arrs = _arrays(np.random.default_rng(1), n_pts)
    pj = jv.export_html(str(tmp_path / "j" / "viewer.html"), **arrs, meta={"frame": 3})
    pt = tv.export_html(str(tmp_path / "t" / "viewer.html"), **arrs, meta={"frame": 3})
    bj, bt = open(pj, "rb").read(), open(pt, "rb").read()
    assert bt == bj and b"data pool" in bt and b"sdf slice" in bt


def test_export_html_live_is_byte_identical(tmp_path):
    """The polling shell once, the sidecar each refresh (rev from the frame)."""
    from pin_slam_torch.utils import viewer_html as tv
    from pin_slam_tpu.utils import viewer_html as jv

    rng = np.random.default_rng(2)
    for frame in (4, 8):
        arrs = _arrays(rng, 2000)
        meta = {"frame": frame, "map_points": 2000, "loops": 1, "paused": False,
                "sensor": [0.5, 1.0, 0.0]}
        for mod, sub in ((jv, "j"), (tv, "t")):
            mod.export_html(str(tmp_path / sub / "viewer.html"), **arrs, live=True,
                            meta=dict(meta))
        for name in ("viewer.html", "viewer_data.js"):
            assert (open(tmp_path / "t" / name, "rb").read()
                    == open(tmp_path / "j" / name, "rb").read()), (frame, name)
    assert '"rev": 8' in open(tmp_path / "t" / "viewer_data.js").read()


def test_sensor_glyphs_match(tmp_path):
    from pin_slam_torch.dataset import io as tio
    from pin_slam_torch.utils import sensor_cad as tcad
    from pin_slam_tpu.utils import sensor_cad as jcad

    assert tcad.NAMES == jcad.NAMES
    for name in tcad.NAMES + ("car", "unknown"):
        (tv, tf), (jv, jf) = tcad.glyph(name), jcad.glyph(name)
        assert tv.dtype == jv.dtype == np.float32 and tf.dtype == jf.dtype == np.int64
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    pt, pj = tcad.write_all(str(tmp_path / "t")), jcad.write_all(str(tmp_path / "j"))
    assert pt.keys() == pj.keys() == set(tcad.NAMES)
    for name in tcad.NAMES:
        assert open(pt[name], "rb").read() == open(pj[name], "rb").read(), name
        d = tio.read_ply(pt[name])
        np.testing.assert_array_equal(np.stack([d["x"], d["y"], d["z"]], 1), tcad.glyph(name)[0])


@pytest.fixture
def system(tmp_path):
    from test_torch_pipeline import _config

    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, True)
    cfg.run_path = str(tmp_path)
    s = SlamSystem(cfg, device="cpu")
    s.frame_id = 3
    return s


def test_control_channel_pause_step_mesh(system, tmp_path):
    """tests/test_viewer.py's control sequence on the port's SlamSystem."""
    S = system
    S._poll_control()                       # no control file: nothing
    assert not S._mesh_now
    S._write_control({"mesh_now": True})    # one-shot, consumed from the file
    S._poll_control()
    assert S._mesh_now is True
    assert json.load(open(tmp_path / "control.json")) == {}

    S._write_control({"pause": True})       # pause + step: held until a step is granted

    def release():
        time.sleep(0.6)
        S._write_control({"pause": True, "step": 2})

    t = threading.Thread(target=release)
    t.start()
    t0 = time.perf_counter()
    S._poll_control()                       # consumes one step
    took = time.perf_counter() - t0
    t.join()
    assert took > 0.4
    assert json.load(open(tmp_path / "control.json"))["step"] == 1
    S._poll_control()                       # the second step passes at once
    assert json.load(open(tmp_path / "control.json"))["step"] == 0

    S._write_control({"pause_at_loop": True})   # latched for the loop-closure hook
    S._poll_control()
    assert S._pause_at_loop is True
    assert not S._warned_keys


def test_control_live_mc_retune(system):
    S = system
    S._vis_mesher = object()                # stands in for a built mesher
    S._write_control({"mc_res_m": 0.2, "mesh_min_nn": 6})
    S._poll_control()
    assert S._mc_overrides == {"mc_res_m": 0.2, "mesh_min_nn": 6}
    assert S._vis_mesher is None            # rebuilt with the new parameters
    S._vis_mesher = marker = object()       # unchanged parameters keep the mesher
    S._poll_control()
    assert S._vis_mesher is marker


def test_pause_marks_the_live_viewer(system, tmp_path):
    """A pause rewrites only the live viewer's status line (paused, a new
    rev), as the JAX package's _refresh_viewer_meta does, and resuming
    clears it."""
    from pin_slam_torch.utils.viewer_html import export_html

    S = system
    pts = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    export_html(str(tmp_path / "viewer.html"), neural_points=pts, live=True,
                meta={"frame": 3, "paused": False})
    layers = open(tmp_path / "viewer_data.js").read().split(", {")[0]
    S._refresh_viewer_meta(paused=True)
    txt = open(tmp_path / "viewer_data.js").read()
    assert txt.startswith(layers) and '"paused": true' in txt and '"rev": "3p"' in txt
    S._refresh_viewer_meta(paused=False)
    assert '"paused": false' in open(tmp_path / "viewer_data.js").read()
    assert not S._warned_keys


def test_viewer_server_control_post_on_localhost(tmp_path):
    from pin_slam_torch.utils import viewer_server as vs

    httpd = vs.make_server(str(tmp_path), 0)
    assert httpd.server_address[0] == "127.0.0.1"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]
    try:
        for patch in ({"pause": True}, {"step": 3}):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/control",
                                         data=json.dumps(patch).encode(), method="POST")
            assert urllib.request.urlopen(req, timeout=10).status == 200
        assert json.load(open(tmp_path / "control.json")) == {"pause": True, "step": 3}
        (tmp_path / "viewer.html").write_text("<html></html>")
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/viewer.html", timeout=10).read()
        assert body == b"<html></html>"
    finally:
        httpd.shutdown()
        httpd.server_close()


# ----------------------------------------------------------------------
# in-run artifacts: tests/test_periodic_vis.py's sequence through both packages
# ----------------------------------------------------------------------


def _periodic_sequence(root, n_frames=5):
    rng = np.random.default_rng(5)
    os.makedirs(f"{root}/velodyne", exist_ok=True)
    poses = []
    for f in range(n_frames):
        origin = np.array([0.3 * f, 0.0, 0.0])
        g = np.column_stack([rng.uniform(2, 10, 4000), rng.uniform(-5, 5, 4000),
                             np.full(4000, -1.5)])
        w = np.column_stack([np.full(4000, 12.0) + 0.02 * rng.standard_normal(4000),
                             rng.uniform(-5, 5, 4000), rng.uniform(-1.5, 2.0, 4000)])
        pts = (np.concatenate([g, w]) - origin).astype(np.float32)
        np.concatenate([pts, np.zeros((pts.shape[0], 1), np.float32)],
                       axis=1).tofile(f"{root}/velodyne/{f:06d}.bin")
        T = np.eye(4)
        T[:3, 3] = origin
        poses.append(T)
    with open(f"{root}/poses.txt", "w") as fp:
        for T in poses:
            fp.write(" ".join(f"{v:.9f}" for v in T[:3, :].reshape(-1)) + "\n")


def _periodic_config(Config, root, out):
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/velodyne", f"{root}/poses.txt"
    cfg.track_on = cfg.pgo_on = False
    cfg.silence = True
    cfg.min_range, cfg.max_range = 1.5, 20.0
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 2048, 5, 2
    cfg.o3d_vis_on = True
    cfg.mesh_freq_frame = cfg.sdfslice_freq_frame = 2
    cfg.mc_res_m = 0.4
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 14
    cfg.buffer_size, cfg.frame_bucket, cfg.source_bucket = 1 << 18, 1 << 12, 1 << 10
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 16, 1 << 17
    cfg._derive()
    cfg.output_root, cfg.name = out, "vis_run"
    return cfg


def _verts(path):
    from pin_slam_torch.dataset import io as tio

    d = tio.read_ply(path)
    return np.stack([d["x"], d["y"], d["z"]], 1)


def test_periodic_artifacts_match_jax(tmp_path):
    from scipy.spatial import cKDTree
    from test_torch_pipeline import JaxDraws, _sync_from_jax

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    root = str(tmp_path / "seq")
    _periodic_sequence(root)
    jsys = JSlam(_periodic_config(JConfig, root, str(tmp_path / "jax")))
    tcfg = _periodic_config(TConfig, root, str(tmp_path / "torch"))
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    vis_ms = []
    for i in range(5):
        _sync_from_jax(tsys, jsys)
        jsys.process_frame(jsys.dataset.preprocess_frame(i))
        info = tsys.process_frame(tsys.dataset.preprocess_frame(i))
        vis_ms.append(info.get("vis_ms", {}))
    jvis, tvis = (os.path.join(str(tmp_path / d), "vis_run", "vis") for d in ("jax", "torch"))
    names = sorted(os.listdir(tvis))
    assert names == sorted(os.listdir(jvis))
    assert {"mesh_00002.ply", "mesh_00004.ply", "sdf_slice_00000.ply",
            "sdf_slice_00002.ply", "sdf_slice_00004.ply"} <= set(names), names
    assert [sorted(m) for m in vis_ms] == [["sdf_slice"], [], ["mesh", "sdf_slice", "viewer"],
                                          [], ["mesh", "sdf_slice", "viewer"]]
    for name in ("mesh_00002.ply", "mesh_00004.ply"):
        vt, vj = _verts(os.path.join(tvis, name)), _verts(os.path.join(jvis, name))
        assert abs(len(vt) - len(vj)) <= 0.1 * len(vj) and len(vj) > 100, (name, len(vt),
                                                                           len(vj))
        for a, b in ((vt, vj), (vj, vt)):
            assert cKDTree(b).query(a)[0].max() < 0.5 * tcfg.mc_res_m, name
    for f in ("viewer.html", "viewer_data.js"):
        assert os.path.exists(os.path.join(str(tmp_path / "torch"), "vis_run", f))
    assert not tsys._warned_keys
    tsys.save_artifacts(tcfg.output_root + "/vis_run")
    assert "const LIVE = false" in open(os.path.join(tcfg.output_root, "vis_run",
                                                     "viewer.html")).read()
