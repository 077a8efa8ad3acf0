"""The port's process-group bring-up (pin_slam_torch/parallel/distributed.py)
against the JAX package's multi-host path (pin_slam_tpu/parallel/
distributed.py, tests/test_distributed.py): the configuration sources, the
refusals, and 4 real processes posing as 2 nodes x 2 local ranks, whose
node-major data mesh runs tests/_dist_fixture.py's mapping step and must
reproduce the JAX package's on make_mesh(4).

The children (``rank_*``) import only torch and pin_slam_torch."""

import dataclasses
import datetime
import json
import os
import types

import numpy as np
import pytest
import torch

NODES = (0, 1, 0, 1)          # rank -> node: node-major order is 0, 2, 1, 3


def rank_global_mesh(workdir):
    """Bring the group up from torchrun's variables, build the node-major
    mesh and run the fixture's two DP iterations on this rank's indices."""
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.slam import mapper as mp

    assert pdist.initialize(device="cpu", timeout_s=60)
    mesh = pdist.make_global_mesh()
    inf = pdist.info()
    z = np.load(os.path.join(workdir, "inputs.npz"))
    meta = json.load(open(os.path.join(workdir, "meta.json")))

    def ns(prefix):
        n = len(prefix) + 1
        return types.SimpleNamespace(**{k[n:]: z[k] for k in z.files
                                        if k.startswith(prefix + ".")})

    feats, gvec = torch.as_tensor(z["feats"]), torch.as_tensor(z["gvec"])
    loop = pmesh.make_sharded_mapping_loop(mesh, mp.MapperConfig(**meta["mcfg"]))
    _, f, _, _, hist = loop(npts.local_map_from_numpy(ns("lm")), npts.MapConfig(**meta["mc"]),
                            feats, gvec, mp.init_opt_state(feats, gvec),
                            mp.pool_from_numpy(ns("pool")), torch.as_tensor(z["idx"][mesh.rank]),
                            1.0)
    np.savez(os.path.join(workdir, f"out{inf.rank}.npz"), order=np.asarray(mesh.ranks),
             axis=mesh.rank, nodes=np.asarray(inf.nodes), hosts=pdist.host_count(),
             local=inf.local_rank, hist=hist.numpy(), feats=f.numpy())


def test_initialize_is_noop_without_config(monkeypatch):
    from pin_slam_torch.parallel import distributed as pdist

    for k in ("PIN_SLAM_COORDINATOR", "PIN_SLAM_DIST", "PIN_SLAM_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False
    assert pdist.info() is None and pdist.host_count() == 1
    # one process and one device: the one-rank mesh, no collective
    mesh = pdist.make_global_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "none")


def _fake_group(monkeypatch, pdist):
    calls = {}

    def init(backend, init_method=None, world_size=None, rank=None, timeout=None):
        calls.update(backend=backend, init=init_method, world=world_size, rank=rank,
                     timeout=timeout)

    def gather(out, obj):
        out[:] = [obj] * len(out)

    monkeypatch.setattr(pdist, "_INFO", None)
    monkeypatch.setattr(pdist.dist, "init_process_group", init)
    monkeypatch.setattr(pdist.dist, "all_gather_object", gather)
    return calls


def test_initialize_reads_pin_slam_variables(monkeypatch):
    """The PIN_SLAM_* triplet reaches init_process_group as JAX's reaches
    jax.distributed.initialize (tests/test_distributed.py), with an explicit
    timeout, gloo on the CPU and the local rank from LOCAL_RANK."""
    from pin_slam_torch.parallel import distributed as pdist

    calls = _fake_group(monkeypatch, pdist)
    monkeypatch.delenv("PIN_SLAM_DIST", raising=False)
    monkeypatch.delenv("PIN_SLAM_DIST_BACKEND", raising=False)
    monkeypatch.setenv("PIN_SLAM_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("PIN_SLAM_NUM_PROCESSES", "2")
    monkeypatch.setenv("PIN_SLAM_PROCESS_ID", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert pdist.initialize(device="cpu", timeout_s=60) is True
    assert calls == {"backend": "gloo", "init": "tcp://10.0.0.1:8476", "world": 2, "rank": 1,
                     "timeout": datetime.timedelta(seconds=60)}
    inf = pdist.info()
    assert (inf.rank, inf.world, inf.local_rank, inf.nodes) == (1, 2, 0, (0, 0))
    # explicit arguments come first
    monkeypatch.setattr(pdist, "_INFO", None)
    assert pdist.initialize("file:///tmp/x", 3, 2, device="cpu") is True
    assert (calls["init"], calls["world"], calls["rank"]) == ("file:///tmp/x", 3, 2)
    assert calls["timeout"] == datetime.timedelta(seconds=pdist.DEFAULT_TIMEOUT_S)


def test_initialize_reads_torchrun_variables(monkeypatch):
    from pin_slam_torch.parallel import distributed as pdist

    calls = _fake_group(monkeypatch, pdist)
    monkeypatch.delenv("PIN_SLAM_COORDINATOR", raising=False)
    monkeypatch.setenv("PIN_SLAM_DIST", "1")
    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1", MASTER_ADDR="h",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    assert pdist.initialize(device="cpu") is True
    assert (calls["init"], calls["world"], calls["rank"]) == ("env://", 4, 3)
    assert pdist.info().local_rank == 1
    monkeypatch.setattr(pdist, "_INFO", None)
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="torchrun"):
        pdist.initialize(device="cpu")


def test_backend_choice_is_explicit(monkeypatch):
    """NCCL on CUDA, gloo on the CPU; PIN_SLAM_DIST_BACKEND names another,
    and NCCL on the CPU is refused, never swapped for gloo."""
    from pin_slam_torch.parallel import distributed as pdist

    monkeypatch.delenv("PIN_SLAM_DIST_BACKEND", raising=False)
    assert pdist.backend_for("cuda") == "nccl" and pdist.backend_for("cpu") == "gloo"
    monkeypatch.setenv("PIN_SLAM_DIST_BACKEND", "gloo")
    assert pdist.backend_for("cuda") == "gloo"
    monkeypatch.setenv("PIN_SLAM_DIST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="CUDA"):
        pdist.backend_for("cpu")
    monkeypatch.setenv("PIN_SLAM_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError):
        pdist.backend_for("cuda")


def test_data_mesh_without_group_names_the_launch(monkeypatch):
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pdist, "_INFO", None)
    for make in (pdist.make_global_mesh, pmesh.make_mesh):
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            make(2)


def _fixture_inputs():
    """tests/_dist_fixture.py's map, pool and decoder, built as it builds
    them (rng 42)."""
    import jax
    import jax.numpy as jnp

    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import mapper as jm

    rng = np.random.default_rng(42)
    mc = jn.MapConfig(capacity=1 << 12, local_capacity=1 << 11, hash_size=1 << 14,
                      voxel_size=0.3, feature_dim=8, color_on=False, nn_k=6,
                      max_valid_dist2=3.0 * (3 * 0.3) ** 2, local_map_radius=50.0,
                      travel_dist_window=250.0)
    pts = rng.uniform(-5, 5, size=(1500, 3)).astype(np.float32)
    travel = jnp.zeros((64,), jnp.float32)
    state = jn.map_insert(jn.init_map_state(mc), mc, jnp.asarray(pts), jnp.ones((1500,), bool),
                          jnp.int32(0), travel, downsample_table_size=1 << 15)
    lm = jn.build_local_map(state, mc, jnp.zeros(3), jnp.int32(0), travel)
    offsets = jnp.asarray(jn.neighbor_offsets(2, 0.2))
    mcfg = jm.MapperConfig(
        pool_capacity=1 << 12, new_idx_capacity=1 << 10, bs=256, bs_new_sample=32, iters=2,
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
                          jnp.int32(0), jnp.zeros((n,), bool), knn_gidx=gidx, knn_w=w,
                          knn_vec=vecb)
    geo = jdec.init_decoder(jax.random.PRNGKey(1), 11, 64, 1, 1)
    return mc, lm, pool, mcfg, geo


def test_two_nodes_of_two_ranks_match_the_jax_fixture(tmp_path):
    """4 processes over gloo, ranks 0 and 2 on node 0 and ranks 1 and 3 on
    node 1 (torchrun's GROUP_RANK): the data mesh is node-major (0, 2, 1, 3)
    on every rank, the host count is 2, the local ranks count within each
    node, and _dist_fixture.run_mapping_step's two DP iterations, each
    axis index d drawing JAX's fold_in(key, d) indices, match the JAX
    package's on make_mesh(4) within tests/test_distributed.py's
    tolerances, bit-identically on every rank."""
    import jax
    import jax.numpy as jnp

    from _dist_fixture import run_mapping_step
    from pin_slam_tpu.parallel import mesh as jpmesh
    from pin_slam_tpu.slam import mapper as jm
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.slam import mapper as tm
    from torch_port_util import pack_jax_decoder, spawn_ranks

    hist_ref, feats_ref = run_mapping_step(jpmesh.make_mesh(4))
    mc, lm, pool, mcfg, geo = _fixture_inputs()
    shard = dataclasses.replace(mcfg, bs=mcfg.bs // 4, bs_new_sample=mcfg.bs_new_sample // 4)
    key = jax.random.PRNGKey(7)
    idx = np.stack([np.asarray(jm._sample_batch_indices(jax.random.fold_in(key, d), pool, shard,
                                                        jnp.asarray(False), 2))
                    for d in range(4)]).astype(np.int64)
    L = mc.local_capacity
    arrays = {f"lm.{k}": np.asarray(v) for k, v in lm._asdict().items() if v is not None}
    arrays.update({f"pool.{k}": np.asarray(v) for k, v in pool._asdict().items()
                   if v is not None})
    arrays.update(idx=idx, gvec=pack_jax_decoder(geo).numpy(),
                  feats=np.concatenate([np.asarray(lm.geo_features),
                                        np.zeros((L + 1, 1), np.float32)], 1))
    np.savez(tmp_path / "inputs.npz", **arrays)

    def fields(obj, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in dataclasses.asdict(obj).items() if k in names}

    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"mc": fields(mc, tn.MapConfig), "mcfg": fields(mcfg, tm.MapperConfig)}, f)
    spawn_ranks(4, "test_torch_distributed:rank_global_mesh", tmp_path, mode="torchrun",
                nodes=NODES)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["order"], [0, 2, 1, 3])
        np.testing.assert_array_equal(o["nodes"], NODES)
        assert int(o["axis"]) == [0, 2, 1, 3].index(r)
        assert int(o["hosts"]) == 2 and int(o["local"]) == r // 2
        np.testing.assert_array_equal(o["hist"], outs[0]["hist"])
        np.testing.assert_array_equal(o["feats"], outs[0]["feats"])
    np.testing.assert_allclose(outs[0]["hist"], hist_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0]["feats"], feats_ref, rtol=1e-4, atol=1e-6)
