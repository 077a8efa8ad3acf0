"""The port's end-of-run artifacts against the JAX package on the CPU: PLY and
TUM writers, the saved implicit map (each package loads the other's),
trajectory and mesh evaluation, ``write_results`` and the merged point cloud,
and ``SlamSystem.run`` with ``save_map``, ``save_mesh`` and
``save_merged_pc`` on.  Files must be byte-identical, integers exact, and the
evaluation metrics equal to EVAL_RTOL."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.dataset import io as tio
from pin_slam_torch.eval import mesh as tmesh_eval
from pin_slam_torch.eval import traj as ttraj
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.models.decoder import decoder_from_jax
from pin_slam_torch.utils import experiment as texp
from pin_slam_tpu.dataset import io as jio
from pin_slam_tpu.eval import mesh as jmesh_eval
from pin_slam_tpu.eval import traj as jtraj
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.utils import experiment as jexp

torch.set_num_threads(1)
EVAL_RTOL = 1e-12



def _poses(n, seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)).as_matrix()
    T[:, :3, 3] = np.cumsum(rng.normal([1.5, 0, 0], 0.2, (n, 3)), 0)
    return T


def _noisy(T, seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = T.copy()
    out[:, :3, 3] += rng.normal(0, 0.3, (len(T), 3))
    out[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 0.02, (len(T), 3))).as_matrix() @ T[:, :3, :3]
    return out


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------


@pytest.mark.parametrize("parts", ["points", "all"])
def test_write_ply_byte_equal_and_read_back(parts, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    kw = {}
    if parts == "all":
        kw = dict(colors=rng.random((300, 3)).astype(np.float32),
                  normals=rng.normal(size=(300, 3)).astype(np.float32),
                  faces=rng.integers(0, 300, (150, 3)),
                  extra={"certainty": rng.random(300).astype(np.float32)})
    tio.write_ply(str(tmp_path / "t.ply"), pts, **kw)
    jio.write_ply(str(tmp_path / "j.ply"), pts, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    d, dj = tio.read_ply(str(tmp_path / "t.ply")), jio.read_ply(str(tmp_path / "t.ply"))
    assert d.keys() == dj.keys()
    for k in d:
        np.testing.assert_array_equal(d[k], dj[k], err_msg=k)
    np.testing.assert_array_equal(np.stack([d["x"], d["y"], d["z"]], 1), pts)
    if parts == "all":
        np.testing.assert_array_equal(d["faces"], kw["faces"])
        np.testing.assert_array_equal(d["certainty"], kw["extra"]["certainty"])


def test_write_tum_and_kitti_poses_byte_equal(tmp_path):
    T = _poses(20, 1)
    for fn in ("write_tum_poses", "write_kitti_poses"):
        getattr(tio, fn)(str(tmp_path / "t.txt"), T)
        getattr(jio, fn)(str(tmp_path / "j.txt"), T)
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes(), fn


# ----------------------------------------------------------------------
# the saved implicit map
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved_maps(tmp_path_factory):
    """A JAX map (two passes, certainties and features set) and decoder, the
    same carried into the port, each saved by its own package."""
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_tpu.config import Config as JConfig

    over = dict(map_capacity=1 << 13, local_map_capacity=1 << 11, buffer_size=1 << 15,
                downsample_hash_size=1 << 15)
    jmc = jn.MapConfig.from_config(small_config(JConfig, **over))
    tmc = tn.MapConfig.from_config(small_config(TConfig, **over))
    rng = np.random.default_rng(3)
    travel = jnp.arange(64, dtype=jnp.float32)
    js = jn.init_map_state(jmc)
    for ts in (0, 5):
        pts = rng.uniform(-6, 6, (2000, 3)).astype(np.float32)
        js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.ones(2000, bool), jnp.int32(ts),
                           travel, downsample_table_size=1 << 15)
    n = int(js.count)
    attr = np.asarray(js.attr_rows).copy()
    attr[:n, jn.C_CERT] = rng.uniform(0, 20, n)
    q = rng.normal(size=(n, 4))
    attr[:n, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats = np.asarray(js.geo_features).copy()
    feats[:n] = rng.normal(size=(n, feats.shape[1]))
    js = js._replace(attr_rows=jnp.asarray(attr), geo_features=jnp.asarray(feats))
    p = jdec.init_decoder(jax.random.PRNGKey(2), feats.shape[1] + 3, 64, 1, 1)
    d = tmp_path_factory.mktemp("maps")
    jexp.save_implicit_map(str(d / "jax.npz"), js, p)
    texp.save_implicit_map(str(d / "port.npz"), tn.state_from_numpy(js), decoder_from_jax(p))
    return dict(jmc=jmc, tmc=tmc, js=js, p=p, dir=d)


def test_saved_map_same_keys_and_arrays(saved_maps):
    a = np.load(saved_maps["dir"] / "port.npz")
    b = np.load(saved_maps["dir"] / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_params_equal(p, q):
    for (W, b), (W2, b2) in zip(p.hidden + (p.out,), q.hidden + (q.out,)):
        np.testing.assert_array_equal(np.asarray(W), np.asarray(W2))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(b2))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_map_loads_in_both_packages(writer, saved_maps):
    """Whichever package wrote the file, each package loads it to the same
    map, hash table included, and the same decoder."""
    path = str(saved_maps["dir"] / f"{writer}.npz")
    js, jp, jsem, jcol = jexp.load_implicit_map(path, saved_maps["jmc"])
    assert jsem is None and jcol is None
    ts_, dec = texp.load_implicit_map(path, saved_maps["tmc"], "cpu")
    assert int(ts_.count) == int(js.count) == int(saved_maps["js"].count)
    for f in ("attr_rows", "geo_features", "hash_table"):
        np.testing.assert_array_equal(np_(getattr(ts_, f)), np_(getattr(js, f)), err_msg=f)
    _jax_params_equal(jp, saved_maps["p"])
    for (W, b), (Wj, bj) in zip(dec.layers(), jp.hidden + (jp.out,)):
        np.testing.assert_array_equal(np_(W), np.asarray(Wj))
        np.testing.assert_array_equal(np_(b), np.asarray(bj))


@pytest.fixture(scope="module")
def encoded_maps(saved_maps, tmp_path_factory):
    """The saved map's points and features with a decoder at the width of
    NeRF positional encoding of 4 bands (8 + 27 inputs), saved by each
    package; the file records no encoder, the configuration gives it."""
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_tpu.config import Config as JConfig

    over = dict(map_capacity=1 << 13, local_map_capacity=1 << 11, buffer_size=1 << 15,
                downsample_hash_size=1 << 15, pos_encoding_band=4)
    jmc = jn.MapConfig.from_config(small_config(JConfig, **over))
    tmc = tn.MapConfig.from_config(small_config(TConfig, **over))
    assert tmc.vec_dim == 27
    js = saved_maps["js"]
    p = jdec.init_decoder(jax.random.PRNGKey(4), js.geo_features.shape[1] + 27, 64, 1, 1)
    d = tmp_path_factory.mktemp("maps_pe")
    jexp.save_implicit_map(str(d / "jax.npz"), js, p)
    texp.save_implicit_map(str(d / "port.npz"), tn.state_from_numpy(js), decoder_from_jax(p))
    return dict(jmc=jmc, tmc=tmc, js=js, dir=d)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_map_with_encoding_loads_in_both_packages(writer, encoded_maps):
    """A map saved with positional encoding on, by either package, loads in
    both; both decode the same SDF at 1,000 seeded points (kNN, the encoded
    interpolation and the decoder) within 1e-5."""
    path = str(encoded_maps["dir"] / f"{writer}.npz")
    jmc, tmc = encoded_maps["jmc"], encoded_maps["tmc"]
    js, jp, _, _ = jexp.load_implicit_map(path, jmc)
    ts_, dec = texp.load_implicit_map(path, tmc, "cpu")
    assert dec.hidden[0].in_features == 8 + 27
    travel = np.zeros(64, np.float32)
    jlm = jn.build_local_map(js, jmc, jnp.zeros(3), jnp.int32(5), jnp.asarray(travel))
    tlm = tn.build_local_map(ts_, tmc, torch.zeros(3), 5, torch.as_tensor(travel))
    n = int(js.count)
    rng = np.random.default_rng(6)
    pts = (np.asarray(js.attr_rows)[rng.integers(0, n, 1000), :3]
           + rng.normal(0, 0.2, (1000, 3))).astype(np.float32)
    cells = jn.neighbor_offsets(2, 0.2)

    def jsdf(q):
        knn = jn.knn_search(jlm, jmc, q, jnp.asarray(cells))
        g, _, w, _ = jn.interpolate_features(jlm, jmc, q, knn.lidx)
        return jdec.blended_sdf(jp, g, w, jmc.weighted_first, 1.0)[0]

    ref = jax.jit(jsdf)(jnp.asarray(pts))
    knn = tn.knn_search(tlm, tmc, torch.as_tensor(pts), torch.as_tensor(cells))
    g, w, _ = tn.interpolate_features(tlm, tmc, torch.as_tensor(pts), knn.lidx)
    out = dec.blended_sdf(g, w, tmc.weighted_first, 1.0)[0]
    assert (np_(knn.lidx) < tmc.local_capacity).any(1).mean() > 0.5
    np.testing.assert_allclose(np_(out), np_(ref), rtol=0, atol=1e-5)
    # a configuration without the encoder cannot read this decoder
    with pytest.raises(ValueError, match="27|35"):
        texp.load_implicit_map(path, dataclasses.replace(tmc, pos_encoding_band=0), "cpu")


# ----------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------


@pytest.mark.parametrize("align", [True, False])
def test_trajectory_errors_match(align):
    gt = _poses(120, 4)
    est = _noisy(gt, 5)
    np.testing.assert_allclose(ttraj.absolute_error(gt, est, align=align),
                               jtraj.absolute_error(gt, est, align=align), rtol=EVAL_RTOL)
    # 120 frames of ~1.5 m reach the 100 and 200 m KITTI segments
    d = ttraj.relative_error(gt, est)
    assert d[0] > 0
    np.testing.assert_allclose(d, jtraj.relative_error(gt, est), rtol=EVAL_RTOL)
    R, t = ttraj.align_umeyama(gt[:, :3, 3], est[:, :3, 3])
    Rj, tj = jtraj.align_umeyama(gt[:, :3, 3], est[:, :3, 3])
    np.testing.assert_allclose(R, Rj, rtol=EVAL_RTOL)
    np.testing.assert_allclose(t, tj, rtol=EVAL_RTOL)


@pytest.mark.parametrize("native", ["0", "1"])
def test_eval_mesh_matches(native, monkeypatch):
    """scipy path (PIN_NATIVE=0) and the native k-d tree, each in both
    packages, on a sphere's mesh against noisy surface samples."""
    from pin_slam_torch.ops import marching_cubes as tmc_mod

    monkeypatch.setenv("PIN_NATIVE", native)
    xs = np.linspace(-1.5, 1.5, 40)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    v, f = tmc_mod.marching_tetrahedra(np.linalg.norm(g, axis=-1) - 1.0, origin=(-1.5,) * 3,
                                       spacing=xs[1] - xs[0], use_native=False)
    rng = np.random.default_rng(6)
    gt = rng.normal(size=(20000, 3))
    gt = gt / np.linalg.norm(gt, axis=1, keepdims=True) * (1 + 0.02 * rng.normal(size=(20000, 1)))
    mt = tmesh_eval.eval_mesh(v, f, gt, n_samples=8000, threshold=0.03)
    mj = jmesh_eval.eval_mesh(v, f, gt, n_samples=8000, threshold=0.03)
    assert mt.keys() == mj.keys() and 0.3 < mt["fscore"] < 1.0
    for k in mt:
        np.testing.assert_allclose(mt[k], mj[k], rtol=EVAL_RTOL, err_msg=k)


# ----------------------------------------------------------------------
# write_results and the merged point cloud, on one KITTI-format sequence
# ----------------------------------------------------------------------


def _sequence(root, n=6):
    """KITTI-format frames (x, y, z, intensity) and poses on disk."""
    from pin_slam_torch.utils import synthetic as syn

    os.makedirs(f"{root}/velodyne", exist_ok=True)
    world = syn.make_world(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    with open(f"{root}/poses.txt", "w") as fp:
        for i in range(n):
            R, t = syn.sensor_pose(i)
            pts = syn.lidar_scan(rng, world, t, R, 1 << 12)
            inten = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
            np.concatenate([pts, inten], 1).tofile(f"{root}/velodyne/{i:06d}.bin")
            fp.write(" ".join(f"{v:.9f}" for v in np.hstack([R, t[:, None]]).ravel()) + "\n")
    return n


def _datasets(tmp_path, pgo):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset

    root = str(tmp_path / "seq")
    n = _sequence(root)
    out = []
    for Config, Dataset in ((TConfig, TDataset), (JConfig, JDataset)):
        cfg = Config()
        cfg.pc_path, cfg.pose_path, cfg.pgo_on = f"{root}/velodyne", f"{root}/poses.txt", pgo
        cfg.min_range, cfg.max_range = 2.0, 15.0
        cfg._derive()
        ds = Dataset(cfg)
        ds.odom_poses = list(_noisy(ds.gt_poses, 9))
        ds.pgo_poses = list(_noisy(ds.gt_poses, 10))
        ds.time_table = [[0.001 * i, 0.002, 0.003, 0.004, 0.0] for i in range(n)]
        out.append(ds)
    return out


@pytest.mark.parametrize("pgo", [False, True])
def test_write_results_matches(pgo, tmp_path):
    tds, jds = _datasets(tmp_path, pgo)
    mt = tds.write_results(str(tmp_path / "t"))
    mj = jds.write_results(str(tmp_path / "j"))
    assert mt.keys() == mj.keys() and mt["ate_rmse_m"] > 0
    for k in mt:
        np.testing.assert_allclose(mt[k], mj[k], rtol=EVAL_RTOL, err_msg=k)
    for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt", "pose_eval.csv", "time_table.npy"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_merged_point_cloud_byte_equal(tmp_path):
    """The voxel-first merge through the final poses, capped per frame."""
    tds, jds = _datasets(tmp_path, False)
    a = tds.write_merged_point_cloud(str(tmp_path / "t"), vox_down_m=0.24,
                                     max_points_per_frame=3000)
    b = jds.write_merged_point_cloud(str(tmp_path / "j"), vox_down_m=0.24,
                                     max_points_per_frame=3000)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert len(tio.read_ply(a)["x"]) > 1000


# ----------------------------------------------------------------------
# run() with the save options on
# ----------------------------------------------------------------------


def _run_config(Config, root, run_path, **over):
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/velodyne", f"{root}/poses.txt"
    cfg.pgo_on, cfg.silence = False, True
    cfg.min_range, cfg.max_range = 2.0, 15.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 16, 1 << 16
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 15, 1 << 12, 1 << 10
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 2048, 10, 4
    cfg.save_map = cfg.save_mesh = cfg.save_merged_pc = True
    cfg.mc_res_m, cfg.mesh_query_bucket = 0.3, 1 << 14
    cfg.run_path = run_path
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg._derive()
    return cfg


def _listing(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, names in os.walk(root) for f in names}


def test_run_writes_every_artifact(tmp_path):
    """A short run with save_map, save_mesh and save_merged_pc writes the
    files the JAX package's run() writes on the same sequence and
    configuration, viewer.html included: a non-empty mesh with normals, a
    saved map that reloads to the finalised state, and the map's size per
    frame."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlamSystem

    root = str(tmp_path / "seq")
    _sequence(root, 4)
    jrun = str(tmp_path / "jax_run")
    jsystem = JSlamSystem(_run_config(JConfig, root, jrun))
    jsystem.tc = dataclasses.replace(jsystem.tc, min_valid_ratio=0.1)
    jsystem.run()
    expected = _listing(jrun)
    assert {"map/pin_map.npz", "mesh/mesh.ply", "memory_footprint.npy",
            "viewer.html"} <= expected

    run_path = str(tmp_path / "run")
    system = SlamSystem(_run_config(Config, root, run_path), device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    infos = system.run()
    assert len(infos) == 4 and system.metrics["ate_rmse_m"] < 0.2
    assert _listing(run_path) == expected
    mesh = tio.read_ply(os.path.join(run_path, "mesh", "mesh.ply"))
    assert len(mesh["x"]) > 100 and len(mesh["faces"]) > 100
    assert {"nx", "ny", "nz"} <= mesh.keys()
    assert np.isfinite(np.stack([mesh["x"], mesh["y"], mesh["z"]])).all()
    state, dec = texp.load_implicit_map(os.path.join(run_path, "map", "pin_map.npz"),
                                        system.mc, "cpu")
    n = int(system.state.count)
    assert int(state.count) == n > 0
    np.testing.assert_array_equal(np_(state.attr_rows[:n, :10]),
                                  np_(system.state.attr_rows[:n, :10]))
    np.testing.assert_array_equal(np_(dec.pack()), np_(system.decoder.pack()))
    ply = tio.read_ply(os.path.join(run_path, "map", "neural_points.ply"))
    assert len(ply["x"]) == n and "certainty" in ply
    # the map's size per frame, in MB as the JAX package writes it
    mem = np.load(os.path.join(run_path, "memory_footprint.npy"))
    jmem = np.load(os.path.join(jrun, "memory_footprint.npy"))
    assert mem.dtype == jmem.dtype and mem.shape == jmem.shape == (4,)
    point_mb = (system.config.feature_dim + 7) * 4 / 2**20
    np.testing.assert_array_equal(mem, np.array([int(c) for c in system.map_counts]) * point_mb)
    assert (np.diff(mem) >= 0).all() and mem[0] > 0


def test_load_implicit_map_on_the_gpu_unless_asked(saved_maps, monkeypatch):
    """No device means the GPU: without CUDA the loader raises instead of
    building the map on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.load_implicit_map(str(saved_maps["dir"] / "port.npz"), saved_maps["tmc"])
    state, _ = texp.load_implicit_map(str(saved_maps["dir"] / "port.npz"), saved_maps["tmc"],
                                      "cpu")
    assert state.attr_rows.device.type == "cpu"


@pytest.mark.parametrize("options, error, label", [
    ({"dp_devices": 2}, RuntimeError, "torchrun --nproc-per-node 2"),
    ({"map_shards": 2}, RuntimeError, "torchrun --nproc-per-node 2"),
    ({"layer_norm_on": True}, NotImplementedError, "ROADMAP C 14"),
    ({"fresh_freespace_damp": 0.5}, NotImplementedError, "ROADMAP"),
    ({"map_shards": 2, "dp_devices": 2}, ValueError, "dp_devices"),
    ({"map_shards": 2, "ba_freq_frame": 20}, ValueError, "ba_freq_frame")],
    ids=["dp_devices-2-ROADMAP A 12", "map_shards-2-ROADMAP A 12",
         "layer_norm_on-True-ROADMAP C 14", "fresh_freespace_damp-0.5-ROADMAP",
         "map_shards-with-dp_devices", "map_shards-with-ba_freq_frame"])
def test_still_refused_options_name_their_roadmap_item(options, error, label, tmp_path):
    """The options the port still refuses name their ROADMAP item; the
    multi-device options without a process group of their size name the
    launch (they never run on fewer devices), and the combinations the JAX
    package refuses raise its ValueError."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "seq")
    _sequence(root, 1)
    cfg = _run_config(Config, root, str(tmp_path / "run"), **options)
    with pytest.raises(error, match=label):
        SlamSystem(cfg, device="cpu")


def test_run_with_save_options_on_cpu_only_when_asked(tmp_path, monkeypatch):
    """The end-of-run path runs on the system's device: no CUDA, no default."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "seq")
    _sequence(root, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(_run_config(Config, root, str(tmp_path / "run")))


# ----------------------------------------------------------------------
# the JAX package's two mesh gates, on the port (slow, as there)
# ----------------------------------------------------------------------


@pytest.mark.slow
def test_mesh_fscore_against_gt_geometry(tmp_path):
    """tests/test_mesh_quality.py's gate on the port: a ground plane and a
    wall seen from 5 known poses; inside the core box the mesh has F-score
    > 0.9 at 0.1 m and Chamfer-L1 < 0.08 m against the true surfaces."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    rng = np.random.default_rng(4)
    root = str(tmp_path / "seq")
    os.makedirs(f"{root}/velodyne", exist_ok=True)

    def world_points(n):
        g = np.column_stack([rng.uniform(2, 12, n), rng.uniform(-5, 5, n), np.full(n, -1.5)])
        w = np.column_stack([np.full(n, 12.0), rng.uniform(-5, 5, n), rng.uniform(-1.5, 2.0, n)])
        return np.concatenate([g, w])

    with open(f"{root}/poses.txt", "w") as fp:
        for f in range(5):
            origin = np.array([0.3 * f, 0.0, 0.0])
            pts = (world_points(5000) - origin).astype(np.float32)
            pts += 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
                f"{root}/velodyne/{f:06d}.bin")
            T = np.eye(4)
            T[:3, 3] = origin
            fp.write(" ".join(f"{v:.9f}" for v in T[:3, :].reshape(-1)) + "\n")
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/velodyne", f"{root}/poses.txt"
    cfg.track_on = cfg.pgo_on = False
    cfg.silence = True
    cfg.min_range, cfg.max_range = 1.5, 20.0
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 4
    cfg.mc_res_m, cfg.save_mesh = 0.15, True
    cfg.map_capacity, cfg.local_map_capacity, cfg.buffer_size = 1 << 15, 1 << 14, 1 << 18
    cfg.frame_bucket, cfg.source_bucket = 1 << 13, 1 << 10
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 16, 1 << 17
    cfg._derive()
    system = SlamSystem(cfg, device="cpu")
    for i in range(5):
        system.process_frame(system.dataset.preprocess_frame(i))
    run_path = str(tmp_path / "out")
    system.save_artifacts(run_path)
    d = tio.read_ply(os.path.join(run_path, "mesh", "mesh.ply"))
    verts, faces = np.stack([d["x"], d["y"], d["z"]], axis=1), d["faces"]
    assert verts.shape[0] > 500 and faces.shape[0] > 500

    def in_core(p):
        return (p[:, 0] > 3) & (p[:, 0] < 11.5) & (np.abs(p[:, 1]) < 4.5)

    gt = world_points(40000)
    keep_f = in_core(verts)[faces].all(axis=1)
    old2new = np.cumsum(in_core(verts)) - 1
    m = tmesh_eval.eval_mesh(verts[in_core(verts)], old2new[faces[keep_f]], gt[in_core(gt)],
                             threshold=0.1, n_samples=40000)
    assert m["fscore"] > 0.9, m
    assert m["chamfer_l1"] < 0.08, m


@pytest.mark.slow
def test_mesh_covers_full_extent_past_local_capacity(tmp_path, rng):
    """tests/test_mesh_fullmap.py's gate on the port: a corridor map that
    outgrows local_capacity meshes over > 0.8 of the map's x span."""
    from test_mesh_fullmap import make_corridor_dataset

    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "corridor")
    make_corridor_dataset(root, rng)
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/velodyne", f"{root}/poses.txt"
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.bs, cfg.iters = 4096, 10
    cfg.silence, cfg.pgo_on = True, False
    cfg.map_capacity, cfg.local_map_capacity, cfg.buffer_size = 1 << 16, 1 << 12, 1 << 18
    cfg.frame_bucket, cfg.source_bucket = 1 << 13, 1 << 11
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 17, 1 << 17
    cfg._derive()
    cfg.output_root, cfg.save_mesh = str(tmp_path / "out"), True
    cfg.mc_res_m, cfg.mesh_min_nn = 0.4, 7
    system = SlamSystem(cfg, device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    system.run()
    count = int(system.state.count)
    assert count > cfg.local_map_capacity
    d = tio.read_ply(os.path.join(cfg.output_root, cfg.name, "mesh", "mesh.ply"))
    verts = np.stack([d["x"], d["y"], d["z"]], axis=1)
    pts = np_(system.state.positions[:count])
    span_mesh = verts[:, 0].max() - verts[:, 0].min()
    span_pts = pts[:, 0].max() - pts[:, 0].min()
    assert span_mesh > 0.8 * span_pts, (span_mesh, span_pts)


# ----------------------------------------------------------------------
# chip_smoke's mesh phase, driven on the CPU: its gates
# ----------------------------------------------------------------------


def _smoke_system(tmp_path, monkeypatch):
    """chip_smoke imported, with the CUDA calls of its mesh phase stubbed,
    and a two-frame map of a small sequence on the CPU."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "seq")
    _sequence(root, 2)
    system = SlamSystem(_run_config(Config, root, str(tmp_path / "run"), mc_res_m=0.5),
                        device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    for i in range(2):
        system.process_frame(system.dataset.preprocess_frame(i))
    for f in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, f, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "build_native", lambda: ("unavailable", "not built"))
    os.makedirs(tmp_path / "build")
    return chip_smoke, system


@pytest.mark.parametrize("fault", ["cpu_device", "empty_mesh", "overflowing_chunks"])
def test_chip_smoke_mesh_phase_fails_its_gates(fault, tmp_path, monkeypatch):
    """The phase refuses a grid query that is not on the card, an empty
    mesh, and multi-chunk views that overflow (the device gate passed over
    by collecting failures)."""
    chip_smoke, system = _smoke_system(tmp_path, monkeypatch)
    if fault == "cpu_device":
        with pytest.raises(SystemExit, match="grid query ran on cpu"):
            chip_smoke.mesh_phase("A", system)
        return
    failures = []
    monkeypatch.setattr(chip_smoke, "fail", failures.append)
    if fault == "overflowing_chunks":
        # 1024 rows cannot hold the densest 4 m chunk's view of this map
        monkeypatch.setitem(chip_smoke.PATHS["C"], "multi_chunk_L", 1 << 10)
        res = chip_smoke.mesh_phase("C", system)
        assert any("multi-chunk mesh took" in m for m in failures), failures
        assert res["multi_chunk"]["max_view_count"] == 1 << 10
        return
    monkeypatch.setattr(system, "mesh_map", lambda pts: (np.zeros((0, 3), np.float32),
                                                         np.zeros((0, 3), np.int64), [1]))
    res = chip_smoke.mesh_phase("A", system)
    assert any("empty mesh" in m for m in failures), failures
    assert res["vertices"] == 0 and res["map_reloads"] and res["native"] == "unavailable"
    assert 0 < res["map_points_after"] <= res["map_points_before"]
    assert res["multi_chunk"] is None


def test_chip_smoke_multi_chunk_mesh(tmp_path, monkeypatch):
    """Views of 4096 rows split this 5 k-point map into many chunks, none
    overflowing; the mesh matches the one-chunk mesh, and a whole-map view
    of 4096 rows overflows to the oldest 4096 points."""
    chip_smoke, system = _smoke_system(tmp_path, monkeypatch)
    verts, _, counts = system.save_artifacts(str(tmp_path / "run"))
    n = int(system.state.count)
    assert counts == [n] and n > 1 << 12
    m = chip_smoke.multi_chunk_mesh(system, np_(system.state.positions[:n]), 1 << 12)
    assert m["chunks"] > 1 and m["max_view_count"] < 1 << 12 == m["local_capacity"]
    assert m["vertices"] >= len(verts) > 0 and m["finite"]
    assert chip_smoke._chamfer(m["verts"], verts) <= chip_smoke.MULTI_CHAMFER_FRAC * 0.5
    assert m["overflow_view_count"] == 1 << 12 and m["overflow_view_equal_cpu"]
    assert system.mc.local_capacity == 1 << 13
