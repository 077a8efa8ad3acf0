"""The port's spatially sharded map (pin_slam_torch/parallel/spatial.py)
against the JAX package's (pin_slam_tpu/parallel/spatial.py,
tests/test_spatial.py): the ownership hash, the library (insert, query and
train step) on a (2 data x 2 map) mesh of 4 processes against JAX's
make_mesh2d(2, 2), and the live SlamSystem backend, map_shards: 2 over 2
processes against the port's map_shards: 1 run, with a PGO deformation.

The children (``rank_*``) import only torch and pin_slam_torch."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

N_FRAMES = 5


def _ns(z, prefix):
    n = len(prefix) + 1
    return types.SimpleNamespace(**{k[n:]: z[k] for k in z.files if k.startswith(prefix + ".")})


def _save(path, out):
    np.savez(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                      for k, v in out.items()})


# ----------------------------------------------------------------------
# what the child ranks run
# ----------------------------------------------------------------------


def rank_library(workdir):
    """Insert, query, loss gradients and three train steps on this rank's
    shard of a (2 x 2) mesh."""
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.parallel import spatial as sp
    from pin_slam_torch.slam import mapper as mp

    assert pdist.initialize(device="cpu", timeout_s=60)
    mesh = sp.make_mesh2d(2, 2)
    z = np.load(os.path.join(workdir, "inputs.npz"))
    meta = json.load(open(os.path.join(workdir, "meta.json")))
    mc = npts.MapConfig(**meta["mc"])
    smc = sp.shard_config(mc, 2)
    s = mesh.map.rank
    state = sp.make_sharded_insert(mesh, smc, downsample_table_size=1 << 15)(
        sp.init_sharded_map(mesh, smc), torch.as_tensor(z["pts"]),
        torch.ones(z["pts"].shape[0], dtype=torch.bool), 0, torch.zeros(64))
    out = {"count": state.count, "attr": state.attr_rows, "hash": state.hash_table}
    state.geo_features = torch.as_tensor(z["feat"][s])        # the JAX test's features
    geo = Decoder(mc.feature_dim + 3, 32, 1, 1)
    geo.load_state_dict({k: torch.as_tensor(v) for k, v in vars(_ns(z, "geo")).items()})
    offsets = torch.as_tensor(z["offsets"])
    q = torch.as_tensor(z["queries"])
    out["sdf"], out["nn"] = sp.make_spatial_query(mesh, smc, offsets, 0.055)(state, geo, q, 0.0)

    heads = mp.init_heads(geo)
    B = q.shape[0]
    batch = sp.SpatialBatch(q, torch.as_tensor(z["labels"]), torch.ones(B),
                            torch.ones(B, dtype=torch.bool), 0.0)
    tr = sp.SpatialTrainables(state.geo_features.clone(), heads)
    kw = dict(sigma_sigmoid=0.1, sdf_scale=0.055, loss_weight_on=False)
    out["loss"], out["g_feat"], g_dec = sp.spatial_loss_and_grads(mesh, smc, offsets, state, tr,
                                                                  batch, **kw)
    out.update({f"g_dec{i}": g for i, g in enumerate(g_dec)})
    step, init_opt = sp.make_spatial_train_step(mesh, smc, offsets, lr=0.01, adam_eps=1e-15,
                                                **kw)
    opt, losses = init_opt(tr), []
    for _ in range(3):
        tr, opt, loss = step(state, tr, opt, batch)
        losses.append(loss)
    out["losses"], out["feats"] = torch.stack(losses), tr.features
    out.update({f"dec{i}": x for i, x in enumerate(tr.heads.leaves())})
    _save(os.path.join(workdir, f"lib{pdist.info().rank}.npz"), out)


def rank_live(workdir):
    """map_shards: 2 over the structured sequence, then the bent PGO
    correction, then the end-of-run artifacts (rank 0 alone writes)."""
    from pin_slam_torch.parallel import distributed as pdist

    assert pdist.initialize(device="cpu", timeout_s=60)
    rank = pdist.info().rank
    system = _run_slam(workdir, 2)
    out = _live_outputs(system, np.load(os.path.join(workdir, "q.npz"))["q"])
    be = system._spatial
    pos, _, geo, _, ids, count = be.gather_state_dense(system.state)
    out.update(pos=pos, geo=geo, ids=ids, count=count)
    # the bent trajectory correction of tests/test_spatial.py's PGO case
    st = be.recreate(be.adjust(system.state, torch.as_tensor(_bent_diff())), N_FRAMES - 1)
    pos2, _, _, _, _, c2 = be.gather_state_dense(st)
    win, lm2 = be.extract(st, torch.as_tensor(pos2.mean(axis=0).astype(np.float32)),
                          N_FRAMES - 1, system._travel)
    out.update(pgo_pos=pos2, pgo_count=c2, pgo_window=torch.sum(win.counts),
               pgo_merged=lm2.count, merged_rows=lm2.indices.shape[0] - 1)
    system.state = st
    system.config.save_map, system.config.save_mesh = True, False
    system.save_artifacts(os.path.join(workdir, f"run{rank}"))
    _save(os.path.join(workdir, f"live{rank}.npz"), out)


def _bent_diff(T=1 << 16):
    diff = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    for t in range(N_FRAMES):
        a = 0.003 * t
        diff[t, 0, 0] = diff[t, 1, 1] = np.cos(a)
        diff[t, 0, 1], diff[t, 1, 0] = -np.sin(a), np.sin(a)
        diff[t, 0, 3] = 0.02 * t
    return diff


def _run_slam(root, map_shards):
    """tests/test_spatial.py's _run_slam on the port: GT-driven (track_on
    off), PGO off, its capacities, N_FRAMES frames."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/seq/velodyne", f"{root}/seq/poses.txt"
    cfg.track_on, cfg.pgo_on, cfg.silence = False, False, True
    cfg.min_range, cfg.max_range = 1.0, 12.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 13, 1 << 12
    cfg.buffer_size, cfg.pool_capacity = 1 << 16, 1 << 17
    cfg.downsample_hash_size, cfg.frame_bucket = 1 << 16, 1 << 11
    cfg.bs, cfg.iters = 256, 3
    cfg.map_shards = map_shards
    cfg._derive()
    system = SlamSystem(cfg, device="cpu")
    for i in range(N_FRAMES):
        system.process_frame(system.dataset.preprocess_frame(i))
    return system


def _live_outputs(system, q):
    """The merged (or single) local map's members and the trained SDF and
    neighbour counts at ``q``."""
    from pin_slam_torch.models import neural_points as npts

    lm, mc = system.lm, system.mc
    cnt = int(lm.count)
    qt = torch.as_tensor(q)
    knn = npts.knn_search(lm, mc, qt, system.offsets)
    feat, w, _ = npts.interpolate_features(lm, mc, qt, knn.lidx)
    sdf, _ = system.decoder.blended_sdf(feat, w, mc.weighted_first, system.sdf_scale)
    return {"lm_count": lm.count, "lm_idx": lm.indices[:cnt], "lm_geo": lm.geo_features[:cnt],
            "sdf": sdf, "nn": torch.sum(knn.lidx < mc.local_capacity, dim=-1)}


def _structured_seq(root, rng, n_frames=N_FRAMES):
    """tests/test_spatial.py's tiny KITTI-layout sequence (ground, two walls,
    three boxes) with ground-truth poses."""
    os.makedirs(f"{root}/velodyne", exist_ok=True)
    pts = [np.column_stack([rng.uniform(-5, 15, 9000), rng.uniform(-6, 6, 9000),
                            -1.0 + 0.02 * rng.standard_normal(9000)])]
    for sign in (-5.0, 5.0):
        pts.append(np.column_stack([rng.uniform(-5, 15, 6000),
                                    sign + 0.03 * rng.standard_normal(6000),
                                    rng.uniform(-1.0, 1.5, 6000)]))
    for bx in (0.0, 4.0, 8.0):
        pts.append(np.column_stack([bx + rng.uniform(-0.7, 0.7, 2000),
                                    2.5 + rng.uniform(-0.7, 0.7, 2000),
                                    rng.uniform(-1.0, 1.0, 2000)]))
    world = np.concatenate(pts).astype(np.float32)
    with open(f"{root}/poses.txt", "w") as f:
        for i in range(n_frames):
            T = np.eye(4)
            T[0, 3] = 0.4 * i
            local = world - T[:3, 3]
            d = np.linalg.norm(local, axis=1)
            sub = local[(d > 1.0) & (d < 12.0)]
            sub = sub[rng.choice(len(sub), 1200, replace=False)]
            np.concatenate([sub, np.ones((len(sub), 1), np.float32)], 1).astype(
                np.float32).tofile(f"{root}/velodyne/{i:06d}.bin")
            f.write(" ".join(f"{v:.9f}" for v in T[:3, :].ravel()) + "\n")


# ----------------------------------------------------------------------
# the parent
# ----------------------------------------------------------------------


def test_shard_of_matches_jax():
    """The uint32 ownership hash wraps as JAX's does, for negative and large
    voxel coordinates too."""
    import jax.numpy as jnp

    from pin_slam_torch.parallel import spatial as tsp
    from pin_slam_tpu.parallel import spatial as jsp

    rng = np.random.default_rng(0)
    grid = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, (4000, 3)),
                           rng.integers(-300, 300, (4000, 3))]).astype(np.int32)
    for n in (1, 2, 3, 4, 7):
        np.testing.assert_array_equal(tsp.shard_of(torch.as_tensor(grid), n).numpy(),
                                      np.asarray(jsp.shard_of(jnp.asarray(grid), n)))


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """tests/test_spatial.py's setup on JAX's make_mesh2d(2, 2) and the
    port's 4 ranks."""
    import jax
    import jax.numpy as jnp

    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.ops import losses as jlosses
    from pin_slam_tpu.parallel import spatial as jsp
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import decoder_from_jax
    from torch_port_util import spawn_ranks

    work = str(tmp_path_factory.mktemp("spatial"))
    rng = np.random.default_rng(7)
    mc = jn.MapConfig(capacity=4096, local_capacity=4096, hash_size=1 << 16, voxel_size=0.3,
                      feature_dim=8, color_on=False, nn_k=6,
                      max_valid_dist2=3.0 * (3 * 0.3) ** 2, local_map_radius=1e5,
                      travel_dist_window=1e8, local_hash_size=1 << 16)
    mesh = jsp.make_mesh2d(2, 2)
    smc = jsp.shard_config(mc, 2)
    n = 1500
    side = int(np.ceil(n ** (1 / 3)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    pts = ((cells + 0.2 + 0.6 * rng.random((n, 3))) * 0.3).astype(np.float32)
    travel = jnp.zeros((64,), jnp.float32)
    valid = jnp.ones((n,), bool)
    state1 = jn.map_insert(jn.init_map_state(mc), mc, jnp.asarray(pts), valid, jnp.int32(0),
                           travel, downsample_table_size=1 << 15)
    sstate = jsp.make_sharded_insert(mesh, smc, downsample_table_size=1 << 15)(
        jsp.init_sharded_map(mesh, smc), *(jsp.put_replicated(mesh, x) for x in (
            jnp.asarray(pts), valid, jnp.int32(0), travel)))
    offsets = jn.neighbor_offsets(2, 0.2)
    geo = jdec.init_decoder(jax.random.PRNGKey(3), mc.feature_dim + 3, 32, 1, 1)
    feats = 0.1 * jax.random.normal(jax.random.PRNGKey(4), state1.geo_features.shape)
    active1 = (jnp.arange(mc.capacity + 1) < state1.count)[:, None]
    state1 = state1._replace(geo_features=jnp.where(active1, feats, 0.0))
    lm1 = jn.build_local_map(state1, mc, jnp.zeros(3), jnp.int32(0), travel)
    host = jax.device_get(sstate)
    shard_feats = []
    for s in range(2):
        pos = jnp.asarray(host.attr_rows[s][:, :3])
        gidx = state1.hash_table[jn.spatial_hash(jn.grid_coords(pos, mc.voxel_size),
                                                 mc.hash_size)]
        act = (jnp.arange(pos.shape[0]) < host.count[s])[:, None]
        shard_feats.append(np.asarray(jnp.where(act, state1.geo_features[gidx], 0.0)))
    sstate = jax.tree.map(lambda *xs: jax.device_put(jnp.stack(xs), jsp._map_sharding(mesh)),
                          *[jax.tree.map(lambda x, i=i: jnp.asarray(x[i]), host)._replace(
                              geo_features=jnp.asarray(shard_feats[i])) for i in range(2)])
    queries = (pts[rng.choice(n, 512, replace=False)]
               + rng.normal(0, 0.15, (512, 3))).astype(np.float32)
    labels = rng.normal(0, 0.05, (512,)).astype(np.float32)
    q = jnp.asarray(queries)

    knn = jn.knn_search(lm1, mc, q, jnp.asarray(offsets))
    f1, _, w1, _ = jn.interpolate_features(lm1, mc, q, knn.lidx)
    sdf1 = np.asarray(jdec.blended_sdf(geo, f1, w1, mc.weighted_first, 0.055)[0])
    query = jsp.make_spatial_query(mesh, smc, offsets, 0.055)
    geo_rep = jsp.put_replicated(mesh, geo)
    q_sh = jsp.put_data_sharded(mesh, q)
    sdf2, nn2 = query(sstate, geo_rep, q_sh, jsp.put_replicated(mesh, jnp.float32(0.0)))

    def loss_sp(feats_, geo_):
        pred, _ = query(sstate._replace(geo_features=feats_), geo_, q_sh, jnp.float32(0.0))
        return jlosses.sdf_bce_loss(pred, jnp.asarray(labels), 0.1)

    loss_j, (gf_j, gg_j) = jax.value_and_grad(loss_sp, argnums=(0, 1))(sstate.geo_features,
                                                                        geo_rep)
    step, opt = jsp.make_spatial_train_step(mesh, smc, offsets, lr=0.01, adam_eps=1e-15,
                                            sigma_sigmoid=0.1, sdf_scale=0.055,
                                            loss_weight_on=False)
    batch = jsp.shard_spatial_batch(mesh, jsp.SpatialBatch(
        coord=q, sdf_label=jnp.asarray(labels), weight=jnp.ones((512,), jnp.float32),
        valid=jnp.ones((512,), bool), travel_now=jnp.float32(0.0)))
    tr = jsp.SpatialTrainables(features=sstate.geo_features, geo=geo_rep)
    opt_state, step_losses = opt.init(tr), []
    for _ in range(3):
        tr, opt_state, loss = step(sstate, tr, opt_state, batch)
        step_losses.append(float(loss))

    def layers(p):
        return [np.asarray(x) for pair in list(p.hidden) + [p.out] for x in pair]

    names = {f.name for f in dataclasses.fields(tn.MapConfig)}
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump({"mc": {k: v for k, v in dataclasses.asdict(mc).items() if k in names}}, f)
    np.savez(os.path.join(work, "inputs.npz"), pts=pts, feat=np.stack(shard_feats),
             offsets=offsets, queries=queries, labels=labels,
             **{f"geo.{k}": v.numpy() for k, v in decoder_from_jax(geo).state_dict().items()})
    spawn_ranks(4, "test_torch_spatial:rank_library", work)
    outs = [dict(np.load(os.path.join(work, f"lib{r}.npz"))) for r in range(4)]
    return dict(mc=mc, smc=smc, state1=state1, sstate=jax.device_get(sstate), sdf1=sdf1,
                nn1=np.asarray(knn.nn_count), sdf2=np.asarray(sdf2), nn2=np.asarray(nn2),
                loss=float(loss_j), gf=np.asarray(gf_j), gg=layers(gg_j),
                step_losses=np.asarray(step_losses), step_geo=layers(tr.geo),
                step_feats=np.asarray(tr.features), outs=outs)


def test_insert_counts_and_ownership_match_jax(library):
    """Each map shard (ranks (d, m) hold shard m) inserts exactly the JAX
    package's shard: counts, rows and hash table equal; every point's voxel
    is owned by its shard; the shards hold every point once."""
    from pin_slam_torch.ops.hash3d import grid_coords
    from pin_slam_torch.parallel import spatial as tsp

    js = library["sstate"]
    total = 0
    for r, o in enumerate(library["outs"]):
        s = r % 2
        cnt = int(o["count"])
        assert cnt == int(js.count[s])
        np.testing.assert_array_equal(o["attr"], js.attr_rows[s])
        np.testing.assert_array_equal(o["hash"], js.hash_table[s])
        own = tsp.shard_of(grid_coords(torch.as_tensor(o["attr"][:cnt, :3]), 0.3), 2)
        assert (own.numpy() == s).all()
        total += cnt if r < 2 else 0
    assert total == int(library["state1"].count) == 1500


def test_spatial_query_matches_jax(library):
    """The sharded query's SDF and neighbour counts: equal to the JAX
    package's sharded query's (counts exact), and within
    tests/test_spatial.py's tolerances of the single-device query."""
    for o in library["outs"]:
        np.testing.assert_array_equal(o["nn"], library["nn2"])
        np.testing.assert_allclose(o["sdf"], library["sdf2"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["sdf"], library["sdf1"], rtol=1e-4, atol=1e-5)
        assert (o["nn"] == library["nn1"]).mean() > 0.97


def test_spatial_train_step_matches_jax(library):
    """The loss, the feature gradient on each owning shard and the decoder
    gradient through the autograd all-gather against JAX's value_and_grad
    through its sharded query; three train steps (Adam 0.9 / 0.99) against
    make_spatial_train_step's."""
    for r, o in enumerate(library["outs"]):
        s = r % 2
        np.testing.assert_allclose(float(o["loss"]), library["loss"], rtol=1e-5)
        np.testing.assert_allclose(o["g_feat"], library["gf"][s], rtol=1e-4, atol=1e-7)
        for i, gj in enumerate(library["gg"]):
            gt = o[f"g_dec{i}"]
            np.testing.assert_allclose(gt.T if gt.ndim == 2 else gt, gj,
                                       atol=1e-5 * np.abs(gj).max(), err_msg=f"leaf {i}")
        np.testing.assert_allclose(o["losses"], library["step_losses"], rtol=1e-4)
        for i, pj in enumerate(library["step_geo"]):
            pt = o[f"dec{i}"]
            np.testing.assert_allclose(pt.T if pt.ndim == 2 else pt, pj, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(o["feats"], library["step_feats"][s], rtol=1e-4, atol=1e-6)
        cnt = int(o["count"])
        assert np.abs(o["feats"][cnt:-1]).max() == 0.0      # updates only on active rows
    assert library["step_losses"][-1] < library["step_losses"][0]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    from torch_port_util import spawn_ranks

    work = tmp_path_factory.mktemp("live")
    rng = np.random.default_rng(42)
    _structured_seq(str(work / "seq"), rng)
    q = rng.uniform([-4, -5, -1], [14, 5, 1], size=(2048, 3)).astype(np.float32)
    np.savez(work / "q.npz", q=q)
    spawn_ranks(2, "test_torch_spatial:rank_live", work)
    s1 = _run_slam(str(work), 1)
    one = _live_outputs(s1, q)
    return dict(work=work, s1=s1, one={k: v.numpy() for k, v in one.items()},
                outs=[dict(np.load(work / f"live{r}.npz")) for r in range(2)])


def _keyed(pos):
    k = np.round(pos * 1e4).astype(np.int64)
    return k[:, 0] * (1 << 40) + k[:, 1] * (1 << 20) + k[:, 2]


def test_live_backend_matches_single_device(live):
    """map_shards: 2 against map_shards: 1 on the port, with
    tests/test_spatial.py's assertions: the point counts, >= 0.99 of the
    points in common, every merged-window member's trained feature row on
    its owning shard's global row exactly, the trained SDF fields' median
    difference < 0.05 (0.9 quantile < 0.2), the merged window's count;
    both ranks bit-identical; rank 0 alone writes pin_map.npz."""
    s1, o = live["s1"], live["outs"][0]
    c1, c2 = int(s1.state.count), int(o["count"])
    assert abs(c1 - c2) <= max(3, 0.02 * c1), (c1, c2)
    common = np.intersect1d(_keyed(s1.state.positions[:c1].numpy()), _keyed(o["pos"]))
    assert len(common) >= 0.99 * min(c1, c2)
    id2row = {int(g): i for i, g in enumerate(o["ids"])}
    rows = np.array([id2row[int(g)] for g in o["lm_idx"]])
    np.testing.assert_array_equal(o["geo"][rows], o["lm_geo"])
    one = live["one"]
    both = (one["nn"] >= 3) & (o["nn"] >= 3)
    assert both.sum() > 500
    diff = np.abs(one["sdf"][both] - o["sdf"][both])
    assert np.median(diff) < 0.05, np.median(diff)
    assert np.quantile(diff, 0.9) < 0.2, np.quantile(diff, 0.9)
    assert abs(int(one["lm_count"]) - int(o["lm_count"])) <= max(3, 0.01 * c1)
    for k in ("pos", "geo", "lm_idx", "lm_geo", "sdf", "pgo_pos"):
        np.testing.assert_array_equal(live["outs"][1][k], o[k])
    assert (live["work"] / "run0" / "map" / "pin_map.npz").exists()
    assert not (live["work"] / "run1").exists()


def test_pgo_deformation_matches_single_device(live):
    """After the bent pose-graph correction, the per-shard adjust and rehash
    give the single-device adjust_map / recreate_hash's point set (>= 0.99
    in common), the map moved, and the merged window extracted at the
    corrected map agrees with its shards' windows."""
    from pin_slam_torch.models import neural_points as npts

    s1, o = live["s1"], live["outs"][0]
    c1 = int(s1.state.count)
    before = s1.state.positions[:c1].numpy().copy()
    st1 = npts.recreate_hash(npts.adjust_map(s1.state, s1.mc, torch.as_tensor(_bent_diff())),
                             s1.mc, N_FRAMES - 1, downsample_table_size=1 << 16)
    pos1 = st1.positions[:c1].numpy()
    c2 = int(o["pgo_count"])
    assert abs(c1 - c2) <= max(3, 0.02 * c1), (c1, c2)
    common = np.intersect1d(_keyed(pos1), _keyed(o["pgo_pos"]))
    assert len(common) >= 0.99 * min(c1, c2)
    assert np.abs(pos1 - before).max() > 0.01
    assert int(o["pgo_merged"]) == min(int(o["pgo_window"]), int(o["merged_rows"]))


def test_sharding_refusals_and_the_id_bound():
    """As in the JAX package: map_shards with dp_devices, and with bundle
    adjustment, raise ValueError; so does a merged capacity past 2^24."""
    import dataclasses as dc

    from pin_slam_torch.config import Config
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.parallel import spatial as sp
    from pin_slam_torch.slam.pipeline import SlamSystem

    for key, val, msg in (("dp_devices", 2, "dp_devices"), ("ba_freq_frame", 20, "ba_freq_frame")):
        cfg = Config()
        cfg.map_shards = 2
        setattr(cfg, key, val)
        cfg._derive()
        with pytest.raises(ValueError, match=msg):
            SlamSystem(cfg, device="cpu")
    two = pmesh.Mesh(group=None, rank=0, size=2, device=torch.device("cpu"), ranks=(0, 1),
                     backend="gloo", axis=sp.MAP_AXIS)
    mesh = sp.Mesh2D(data=pmesh.single_mesh("cpu"), map=two)
    mc = npts.MapConfig(capacity=1 << 24, local_capacity=1 << 12, hash_size=1 << 16,
                        voxel_size=0.3, feature_dim=8, nn_k=6, max_valid_dist2=2.0,
                        local_map_radius=50.0, travel_dist_window=250.0)
    with pytest.raises(ValueError, match="2\\^24"):
        sp.LiveBackend(mesh, mc)
    be = sp.LiveBackend(mesh, dc.replace(mc, capacity=(1 << 24) - 2))
    assert be.mc_merged.capacity == (1 << 24) - 1 and be.mc_merged.local_capacity == 1 << 12
