"""The port's data parallelism (pin_slam_torch/parallel/mesh.py and its
wiring) against the JAX package's (pin_slam_tpu/parallel/mesh.py), with the
port's ranks as real processes over gloo on the CPU (started by
``torch_port_util.spawn_ranks``) and the JAX reference on the parent's 8
fake CPU devices.

The children import only torch and pin_slam_torch: the ``rank_*`` functions
below are what they run (this module imports JAX only inside its tests).
Inputs and results travel as .npz files in the test's directory."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

WORLD = 4
ITERS = 3


# ----------------------------------------------------------------------
# what a child rank runs (torch and pin_slam_torch only)
# ----------------------------------------------------------------------


def _ns(z, prefix):
    """The arrays ``prefix.*`` of an npz as an object with those attributes."""
    n = len(prefix) + 1
    return types.SimpleNamespace(**{k[n:]: z[k] for k in z.files if k.startswith(prefix + ".")})


def _decoder(z, meta, name):
    from pin_slam_torch.models.decoder import Decoder

    m = meta[name]
    dec = Decoder(m["in"], m["hidden"], m["level"], m["out"], m["bias"])
    dec.load_state_dict({k: torch.as_tensor(v) for k, v in vars(_ns(z, name)).items()})
    return dec


def rank_loops(workdir):
    """The DP cached loop (eikonal off and on), the DP autograd loop with a
    semantic head, the DP mesher and the plain DP train step, on this
    rank's share."""
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.mesher import Mesher, MesherConfig

    assert pdist.initialize(device="cpu", timeout_s=60)
    mesh = pmesh.make_mesh(WORLD)
    z = np.load(os.path.join(workdir, "inputs.npz"))
    meta = json.load(open(os.path.join(workdir, "meta.json")))
    mc = npts.MapConfig(**meta["mc"])
    lm = npts.local_map_from_numpy(_ns(z, "lm"))
    out = {}
    for case in ("eik0", "eik1"):
        mcfg = mp.MapperConfig(**meta[case])
        pool = mp.pool_from_numpy(_ns(z, "pool"))
        feats, gvec = torch.as_tensor(z["feats"]), torch.as_tensor(z["gvec"])
        loop = pmesh.make_sharded_mapping_loop(mesh, mcfg)
        assert loop.mcfg.bs == mcfg.bs // WORLD and not loop.autograd
        lm2, f, g, _, hist = loop(lm, mc, feats, gvec, mp.init_opt_state(feats, gvec), pool,
                                  torch.as_tensor(z["idx"][mesh.rank]), 1.0)
        out.update({f"{case}.hist": hist, f"{case}.feats": f, f"{case}.gvec": g,
                    f"{case}.attr": lm2.attr_rows})

    smc = npts.MapConfig(**meta["sem_mc"])
    slm = npts.local_map_from_numpy(_ns(z, "slm"))
    mcfg = mp.MapperConfig(**meta["sem"])
    heads = mp.init_heads(_decoder(z, meta, "sgeo"), _decoder(z, meta, "ssem"))
    feats = torch.as_tensor(z["sfeats"])
    loop = pmesh.make_sharded_mapping_loop(mesh, mcfg, autograd=True)
    lm2, f, heads, _, hist = loop(slm, smc, feats, heads, mp.init_opt_state(feats, heads),
                                  mp.pool_from_numpy(_ns(z, "spool")),
                                  torch.as_tensor(z["sidx"][mesh.rank]), 0.7)
    out.update({"sem.hist": hist, "sem.feats": f, "sem.attr": lm2.attr_rows})
    out.update({f"sem.leaf{i}": x for i, x in enumerate(heads.leaves())})

    geo = _decoder(z, meta, "geo")
    offsets = torch.as_tensor(z["offsets"])
    mcf = MesherConfig(mc_res_m=0.3, mesh_min_nn=6, min_cluster_vertices=0, query_bucket=512)
    coords = z["queries"][:1000]                   # not a multiple of the bucket: padding
    out["mesh.sdf_dp"], out["mesh.nn_dp"] = Mesher(mcf, mc, offsets, dp_mesh=mesh) \
        .query_sdf_grid(lm, geo, 0.055, coords)
    out["mesh.sdf"], out["mesh.nn"] = Mesher(mcf, mc, offsets).query_sdf_grid(lm, geo, 0.055,
                                                                             coords)

    mcfg = mp.MapperConfig(**meta["step"])
    step = pmesh.make_sharded_train_step(mesh, mc, mcfg, offsets)
    heads = mp.init_heads(geo)
    f = lm.geo_features.clone()
    opt = mp.init_opt_state(f, heads)
    batch = pmesh.ShardedBatch(torch.as_tensor(z["queries"]), torch.as_tensor(z["labels"]),
                               torch.ones(1024), torch.ones(1024, dtype=torch.bool))
    losses = []
    for _ in range(5):
        f, heads, opt, loss = step(dataclasses.replace(lm, geo_features=f), f, heads, opt,
                                   batch)
        losses.append(loss)
    out.update({"step.losses": torch.stack(losses), "step.feats": f})
    np.savez(os.path.join(workdir, f"out{mesh.rank}.npz"),
             **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})


def rank_slam(workdir):
    """``python -m pin_slam_torch.cli`` with ``dp_devices: 2`` on this rank
    (the CLI brings the group up from the PIN_SLAM_* variables): rank 1 runs
    with every write under the output root refused, so that a write there
    fails the run; the run's poses, map and decoder go to this test's own
    file."""
    import builtins

    from pin_slam_torch import cli
    from pin_slam_torch.slam.pipeline import SlamSystem

    rank = int(os.environ["PIN_SLAM_PROCESS_ID"])
    out_root = os.path.join(workdir, "out")
    if rank != 0:
        real_open, real_makedirs = builtins.open, os.makedirs

        def inside(path):
            return os.path.abspath(str(path)).startswith(os.path.abspath(out_root))

        def guarded_open(path, mode="r", *a, **kw):
            if inside(path) and any(c in mode for c in "wax+"):
                raise PermissionError(f"rank {rank} wrote {path}")
            return real_open(path, mode, *a, **kw)

        def guarded_makedirs(path, *a, **kw):
            if inside(path):
                raise PermissionError(f"rank {rank} made {path}")
            return real_makedirs(path, *a, **kw)

        builtins.open, os.makedirs = guarded_open, guarded_makedirs
    seen = []
    run = SlamSystem.run

    def keep(self, *a, **kw):
        seen.append(self)
        self.tc = dataclasses.replace(self.tc, min_valid_ratio=0.1)
        return run(self, *a, **kw)

    SlamSystem.run = keep
    assert cli.main([os.path.join(workdir, "dp.yaml"), "--device", "cpu"]) == 0
    system = seen[0]
    assert system.dp_mesh.size == 2 and system.train_mcfg.bs == system.mcfg.bs // 2
    np.savez(os.path.join(workdir, f"slam{rank}.npz"),
             poses=np.stack(system.dataset.odom_poses), feats=system.state.geo_features.numpy(),
             attr=system.state.attr_rows.numpy(), decoder=system.decoder.pack().numpy())


SLAM_OVER = dict(min_range=2.0, max_range=20.0, map_capacity=1 << 15, local_map_capacity=1 << 13,
                 buffer_size=1 << 17, pool_capacity=1 << 17, downsample_hash_size=1 << 16,
                 frame_bucket=1 << 13, source_bucket=1 << 11, bs=4096, iters=15,
                 init_iter_ratio=20, save_mesh=True, mesh_query_bucket=1 << 14, mc_res_m=0.3)


def _write_profile(path, **over):
    """A YAML profile holding only ``over`` (each key in its section), read
    by Config.load on top of the defaults."""
    import yaml

    from pin_slam_torch.config import Config

    where = {}
    for sec, keys in Config._SECTION_KEYS.items():
        for yaml_key, attr in keys.items():
            where.setdefault(attr, (sec, yaml_key))
    prof = {}
    for attr, v in over.items():
        sec, key = where[attr]
        prof.setdefault(sec, {})[key] = v
    with open(path, "w") as f:
        yaml.safe_dump(prof, f)


# ----------------------------------------------------------------------
# the parent: JAX references, then the ranks
# ----------------------------------------------------------------------


def _fields(obj, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dataclasses.asdict(obj).items() if k in names}


def _tree(prefix, obj):
    return {f"{prefix}.{k}": np.asarray(v) for k, v in obj._asdict().items() if v is not None}


def _dec_arrays(prefix, p, meta, in_dim, hidden, level, out, bias=True):
    from pin_slam_torch.models.decoder import decoder_from_jax

    meta[prefix] = dict(zip(("in", "hidden", "level", "out", "bias"),
                            (in_dim, hidden, level, out, bias)))
    return {f"{prefix}.{k}": v.numpy() for k, v in decoder_from_jax(p).state_dict().items()}


def _geometry_fixture(rng):
    """tests/test_parallel.py's DP-loop fixture: the map, local map, pool
    with cached kNN and decoder."""
    import jax
    import jax.numpy as jnp

    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import mapper as jm

    mc = jn.MapConfig(capacity=1 << 12, local_capacity=1 << 11, hash_size=1 << 14,
                      voxel_size=0.3, feature_dim=8, color_on=False, nn_k=6,
                      max_valid_dist2=3.0 * (3 * 0.3) ** 2, local_map_radius=50.0,
                      travel_dist_window=250.0)
    pts = rng.uniform(-5, 5, size=(1500, 3)).astype(np.float32)
    travel = jnp.zeros((64,), jnp.float32)
    state = jn.map_insert(jn.init_map_state(mc), mc, jnp.asarray(pts), jnp.ones((1500,), bool),
                          jnp.int32(0), travel, downsample_table_size=1 << 15)
    lm = jn.build_local_map(state, mc, jnp.zeros(3), jnp.int32(0), travel)
    count = int(lm.count)
    lm = lm._replace(geo_features=lm.geo_features.at[:count].set(
        (0.1 * rng.standard_normal((count, 8))).astype(np.float32)))
    offsets = jnp.asarray(jn.neighbor_offsets(2, 0.2))
    mcfg = jm.MapperConfig(
        pool_capacity=1 << 12, new_idx_capacity=1 << 10, bs=256, bs_new_sample=32, iters=3,
        lr=0.01, adam_eps=1e-15, sigma_sigmoid=0.1, sdf_scale=0.055, loss_weight_on=False,
        ekional_loss_on=False, weight_e=0.5, gradient_decimation=8, num_grad_step=0.06,
        surface_sample_range=0.25, semantic_on=False, color_on=False, weight_s=1.0,
        weight_i=1.0)
    n = 1 << 11
    coords = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    labels = (rng.normal(size=n) * 0.1).astype(np.float32)
    gidx, w, vecb = jm.append_knn(lm, mc, offsets, jnp.asarray(coords), ray_sample_count=1,
                                  near_count=1)
    pool = jm.pool_append(jm.init_pool(mcfg, 1), mcfg, jnp.asarray(coords), jnp.asarray(coords),
                          jnp.asarray(labels), jnp.ones((n,), jnp.float32), jnp.ones((n,), bool),
                          jnp.int32(0), jnp.asarray(rng.random(n) > 0.7), knn_gidx=gidx,
                          knn_w=w, knn_vec=vecb)
    geo = jdec.init_decoder(jax.random.PRNGKey(1), 11, 64, 1, 1)
    return mc, lm, pool, mcfg, geo, offsets


def _semantic_fixture(rng, mc, lm):
    """A pool of sampled rays with classes for a semantic head (the shape of
    tests/test_torch_semantic.py's loop inputs)."""
    import jax
    import jax.numpy as jnp

    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import mapper as jm

    mcfg = jm.MapperConfig(
        pool_capacity=1 << 12, new_idx_capacity=1 << 10, bs=256, bs_new_sample=32, iters=3,
        lr=0.01, adam_eps=1e-15, sigma_sigmoid=0.1, sdf_scale=0.055, loss_weight_on=True,
        ekional_loss_on=True, weight_e=0.5, gradient_decimation=8, num_grad_step=0.06,
        surface_sample_range=0.25, semantic_on=True, color_on=False, weight_s=1.0,
        weight_i=1.0)
    pos = np.asarray(lm.attr_rows)[: int(lm.count), :3]
    S, near, n_rays = 7, 4, 120
    ends = pos[rng.integers(0, pos.shape[0], n_rays)]
    coords = (ends[:, None, :] + rng.normal(0, 0.08, (n_rays, S, 3))).astype(np.float32)
    coords[:, 0] = ends
    coords = coords.reshape(-1, 3)
    M = coords.shape[0]
    gidx, w, vec = jm.append_knn(lm, mc, jnp.asarray(jn.neighbor_offsets(2, 0.2)),
                                 jnp.asarray(coords), S, near_count=near)
    label = np.where(np.arange(M) % S == 0, 0.0, rng.normal(0, 0.1, M)).astype(np.float32)
    sem = np.where(np.arange(M) % S < near, rng.integers(0, 20, M), 0).astype(np.int32)
    pool = jm.pool_append(jm.init_pool(mcfg), mcfg, jnp.asarray(coords), jnp.asarray(coords),
                          jnp.asarray(label), jnp.asarray(rng.uniform(0.5, 1.4, M), jnp.float32),
                          jnp.ones((M,), bool), jnp.int32(1), jnp.asarray(rng.random(M) > 0.5),
                          jnp.asarray(sem), None, gidx, w, vec)
    L = mc.local_capacity
    feats = np.concatenate([0.05 * rng.standard_normal((L + 1, 8)), np.zeros((L + 1, 1))],
                           1).astype(np.float32)
    geo = jdec.init_decoder(jax.random.PRNGKey(18), 11, 64, 1, 1)
    semd = jdec.init_decoder(jax.random.PRNGKey(19), 11, 64, 1, 20)
    return mcfg, pool, feats, geo, semd


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The JAX package's DP runs on make_mesh(4) and the port's over 4 ranks,
    from the same state and the same per-rank batch indices."""
    import jax
    import jax.numpy as jnp

    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.parallel import mesh as jpmesh
    from pin_slam_tpu.slam import mapper as jm
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.slam import mapper as tm
    from torch_port_util import pack_jax_decoder, spawn_ranks

    work = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(7)
    mc, lm, pool, mcfg, geo, offsets = _geometry_fixture(rng)
    jmesh = jpmesh.make_mesh(WORLD)
    key = jax.random.PRNGKey(7)
    L = mc.local_capacity
    featsC = jnp.concatenate([lm.geo_features, jnp.zeros((L + 1, 1), jnp.float32)], 1)
    params = jm.TrainableParams(features=featsC, color_features=None, geo=geo, sem=None,
                                color=None)
    meta = {"mc": _fields(mc, tn.MapConfig)}
    ref = {}
    for case, eik in (("eik0", False), ("eik1", True)):
        cfg = dataclasses.replace(mcfg, ekional_loss_on=eik)
        meta[case] = _fields(cfg, tm.MapperConfig)
        out = jpmesh.make_sharded_mapping_loop(jmesh, mc, cfg, num_iters=ITERS)(
            lm, params, jm.init_opt_state(cfg, params), pool, key, jnp.float32(1.0),
            jnp.asarray(False))
        ref[case] = jax.tree.map(np.asarray, out)
    shard = dataclasses.replace(mcfg, bs=mcfg.bs // WORLD,
                                bs_new_sample=max(1, mcfg.bs_new_sample // WORLD))
    idx = np.stack([np.asarray(jm._sample_batch_indices(jax.random.fold_in(key, d), pool, shard,
                                                        jnp.asarray(False), ITERS))
                    for d in range(WORLD)]).astype(np.int64)

    smcfg, spool, sfeats, sgeo, ssem = _semantic_fixture(rng, mc, lm)
    sparams = jm.TrainableParams(features=jnp.asarray(sfeats), color_features=None, geo=sgeo,
                                 sem=ssem, color=None)
    meta["sem"] = _fields(smcfg, tm.MapperConfig)
    meta["sem_mc"] = meta["mc"]
    skey = jax.random.PRNGKey(20)
    ref["sem"] = jax.tree.map(np.asarray, jpmesh.make_sharded_mapping_loop(
        jmesh, mc, smcfg, num_iters=ITERS)(lm, sparams, jm.init_opt_state(smcfg, sparams), spool,
                                           skey, jnp.float32(0.7), jnp.asarray(True)))
    sshard = dataclasses.replace(smcfg, bs=smcfg.bs // WORLD,
                                 bs_new_sample=max(1, smcfg.bs_new_sample // WORLD))
    sidx = np.stack([np.asarray(jm._sample_batch_indices(jax.random.fold_in(skey, d), spool,
                                                         sshard, jnp.asarray(True), ITERS))
                     for d in range(WORLD)]).astype(np.int64)

    # the plain DP step (tests/test_parallel.py's) on make_mesh(4)
    queries = rng.uniform(-4, 4, size=(1024, 3)).astype(np.float32)
    labels = (rng.normal(size=1024) * 0.1).astype(np.float32)
    step_cfg = dataclasses.replace(mcfg, bs=1024, bs_new_sample=0, iters=1)
    meta["step"] = _fields(step_cfg, tm.MapperConfig)
    step = jpmesh.make_sharded_train_step(jmesh, mc, step_cfg, offsets)
    p = jm.TrainableParams(features=lm.geo_features, color_features=None, geo=geo, sem=None,
                           color=None)
    opt = jm.make_optimizer(step_cfg).init(p)
    batch = jpmesh.shard_batch(jmesh, jpmesh.ShardedBatch(
        coord=jnp.asarray(queries), sdf_label=jnp.asarray(labels),
        weight=jnp.ones((1024,), jnp.float32), valid=jnp.ones((1024,), bool)))
    lm_r, p_r, o_r = (jpmesh.replicate_tree(jmesh, x) for x in (lm, p, opt))
    step_losses = []
    for _ in range(5):
        p_r, o_r, loss = step(lm_r, p_r, o_r, batch)
        lm_r = lm_r._replace(geo_features=p_r.features)
        step_losses.append(float(loss))
    ref["step"] = (np.asarray(step_losses), np.asarray(p_r.features))

    # the single-device grid query of the JAX package
    q = jnp.asarray(queries[:1000])
    knn = jn.knn_search(lm, mc, q, offsets)
    feat, _, w, _ = jn.interpolate_features(lm, mc, q, knn.lidx)
    ref["query"] = (np.asarray(jdec.blended_sdf(geo, feat, w, mc.weighted_first, 0.055)[0]),
                    np.asarray(knn.nn_count))

    arrays = {**_tree("lm", lm), **_tree("pool", pool), **_tree("slm", lm),
              **_tree("spool", spool), "feats": np.asarray(featsC),
              "gvec": pack_jax_decoder(geo).numpy(), "idx": idx, "sidx": sidx,
              "sfeats": sfeats, "offsets": np.asarray(offsets), "queries": queries,
              "labels": labels,
              **_dec_arrays("geo", geo, meta, 11, 64, 1, 1),
              **_dec_arrays("sgeo", sgeo, meta, 11, 64, 1, 1),
              **_dec_arrays("ssem", ssem, meta, 11, 64, 1, 20)}
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(meta, f)
    spawn_ranks(WORLD, "test_torch_parallel:rank_loops", work)
    outs = [dict(np.load(os.path.join(work, f"out{r}.npz"))) for r in range(WORLD)]
    return dict(ref=ref, outs=outs, sfeats=sfeats)


@pytest.mark.parametrize("case", ["eik0", "eik1"], ids=["eikonal_off", "eikonal_on"])
def test_dp_cached_loop_matches_jax(loops, case):
    """The DP cached loop (the training kernels' plain twins on the CPU) over
    4 ranks against JAX make_sharded_mapping_loop on make_mesh(4), each rank
    with JAX's fold_in(key, d) indices: tests/test_parallel.py's
    tolerances.  With the eikonal term on as well: both packages take each
    shard's first (bs / n) / gradient_decimation rows."""
    _, p_j, _, hist_j = loops["ref"][case]
    o = loops["outs"][0]
    np.testing.assert_allclose(o[f"{case}.hist"], hist_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(o[f"{case}.feats"][:, :8], p_j.features[:, :8],
                               rtol=1e-3, atol=2e-5)
    lm_j = loops["ref"][case][0]
    np.testing.assert_allclose(o[f"{case}.attr"][:, 7], lm_j.attr_rows[:, 7], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(o[f"{case}.attr"][:, 9], lm_j.attr_rows[:, 9])
    for r in range(1, WORLD):          # every rank holds the same bits
        for k in ("hist", "feats", "gvec", "attr"):
            np.testing.assert_array_equal(loops["outs"][r][f"{case}.{k}"], o[f"{case}.{k}"])


def test_dp_autograd_loop_with_semantic_head_matches_jax(loops):
    """mapping_loop_autograd under DP (semantic head, eikonal and loss
    weights on) against the JAX package's DP loop (its autodiff branch):
    tests/test_torch_semantic.py's leaf tolerances."""
    _, p_j, _, hist_j = loops["ref"]["sem"]
    o = loops["outs"][0]
    np.testing.assert_allclose(o["sem.hist"], hist_j, rtol=1e-4)
    jl = [x for pair in list(p_j.geo.hidden) + [p_j.geo.out] for x in pair if x is not None]
    jl += [x for pair in list(p_j.sem.hidden) + [p_j.sem.out] for x in pair if x is not None]
    tl = [o[f"sem.leaf{i}"] for i in range(len(jl))]
    # the port's leaves are torch.nn.Linear's: weights (out, in)
    pairs = [(o["sem.feats"], p_j.features)] + [
        (t.T if t.ndim == 2 else t, j) for t, j in zip(tl, jl)]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), err_msg=f"leaf {i}")
    assert np.abs(o["sem.feats"] - loops["sfeats"]).max() > 1e-3
    lm_j = loops["ref"]["sem"][0]
    np.testing.assert_allclose(o["sem.attr"][:, 7], lm_j.attr_rows[:, 7],
                               atol=1e-5 * np.abs(lm_j.attr_rows[:, 7]).max())
    for r in range(1, WORLD):
        np.testing.assert_array_equal(loops["outs"][r]["sem.feats"], o["sem.feats"])


def test_dp_mesher_matches_single_query(loops):
    """Mesher(dp_mesh=...) against the plain query (tests/test_parallel.py's
    tolerances) and the JAX package's single-device query."""
    for o in loops["outs"]:
        np.testing.assert_array_equal(o["mesh.nn_dp"], o["mesh.nn"])
        np.testing.assert_allclose(o["mesh.sdf_dp"], o["mesh.sdf"], rtol=1e-5, atol=1e-6)
    sdf_j, nn_j = loops["ref"]["query"]
    np.testing.assert_array_equal(loops["outs"][0]["mesh.nn"], nn_j)
    np.testing.assert_allclose(loops["outs"][0]["mesh.sdf"], sdf_j, rtol=1e-5, atol=1e-6)


def test_dp_train_step_matches_jax(loops):
    """The plain DP step (make_sharded_train_step), 5 steps, against the JAX
    package's on make_mesh(4): the losses fall as there and agree."""
    losses_j, feats_j = loops["ref"]["step"]
    o = loops["outs"][0]
    np.testing.assert_allclose(o["step.losses"], losses_j, rtol=1e-4)
    np.testing.assert_allclose(o["step.feats"], feats_j, rtol=1e-3, atol=2e-5)
    assert o["step.losses"][-1] < o["step.losses"][0]


def test_batch_not_divisible_raises():
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.slam import mapper as tm

    mesh = pmesh.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"), ranks=(0, 1, 2),
                      backend="gloo")
    mcfg = tm.MapperConfig(pool_capacity=64, new_idx_capacity=64, bs=256, bs_new_sample=32,
                           iters=1, lr=0.01, adam_eps=1e-15, sigma_sigmoid=0.1, sdf_scale=0.055,
                           loss_weight_on=False, ekional_loss_on=False, weight_e=0.5,
                           gradient_decimation=8, num_grad_step=0.06, surface_sample_range=0.25)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_sharded_mapping_loop(mesh, mcfg)
    loop = pmesh.make_sharded_mapping_loop(dataclasses.replace(mesh, size=4, ranks=(0, 1, 2, 3)),
                                           mcfg)
    assert (loop.mcfg.bs, loop.mcfg.bs_new_sample) == (64, 8)


def test_dp_slam_system_two_ranks(tmp_path):
    """``pin_slam_torch.cli`` with dp_devices: 2 over 2 ranks: both ranks'
    poses, map and decoder bit-identical, poses within the single-device
    run's gate (tests/test_torch_pipeline.py's 0.15 m on this scene) as the
    port's own single-device run's are, rank 0 alone writes the run
    directory (rank 1 runs with writes there refused), and the DP mesher's
    mesh is in it."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn
    from torch_port_util import spawn_ranks

    root = tmp_path / "seq"
    (root / "velodyne").mkdir(parents=True)
    rng = np.random.default_rng(1)
    world = syn.make_world(np.random.default_rng(0))
    gt = []
    with open(root / "poses.txt", "w") as f:
        for i in range(3):
            R, t = syn.sensor_pose(i)
            pts = syn.lidar_scan(rng, world, t, R, 1 << 13)
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
                str(root / "velodyne" / f"{i:06d}.bin"))
            f.write(" ".join(f"{v:.9f}" for v in np.hstack([R, t[:, None]]).ravel()) + "\n")
            gt.append(t)
    paths = dict(pc_path=str(root / "velodyne"), pose_path=str(root / "poses.txt"))
    _write_profile(tmp_path / "dp.yaml", dp_devices=2, output_root=str(tmp_path / "out"),
                   name="dp", **paths, **SLAM_OVER)
    outs = spawn_ranks(2, "test_torch_parallel:rank_slam", str(tmp_path))
    assert "rank 0/2" in outs[0] and "rank 1/2" in outs[1]
    z0, z1 = (np.load(tmp_path / f"slam{r}.npz") for r in range(2))
    for k in ("poses", "feats", "attr", "decoder"):
        np.testing.assert_array_equal(z0[k], z1[k])
    (run,) = list((tmp_path / "out").iterdir())
    assert json.load(open(run / "summary.json"))["frames"] == 3
    assert (run / "odom_poses_kitti.txt").exists() and (run / "mesh" / "mesh.ply").exists()

    cfg = Config()
    for k, v in {**SLAM_OVER, **paths}.items():
        setattr(cfg, k, v)
    cfg.run_path, cfg.save_mesh = str(tmp_path / "single"), False
    cfg._derive()
    single = SlamSystem(cfg, device="cpu")
    single.tc = dataclasses.replace(single.tc, min_valid_ratio=0.1)
    single.run()
    gt = np.stack(gt)
    assert np.abs(np.stack(single.dataset.odom_poses)[:, :3, 3] - gt).max() < 0.15
    assert np.abs(z0["poses"][:, :3, 3] - gt).max() < 0.15
