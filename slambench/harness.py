"""One run of one cell: set-up, the measured window, the traced frames and
the check that decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs[*].file``: the configuration as it is run (the profile's
  sections, read by ``pin_slam_torch.config.Config.load``, and the
  ``sensor`` block the generator reads);
- ``slambench/traffic/<traffic>.json``: the traffic mix's parameters, with
  the names of the generator module that reads them
  (``slambench/generators/<generator>.py``) and of the frame driver
  (``slambench/drivers/<driver>.py``) that feeds its frames to the program;
- ``slambench/cells/<workload>.json``: the cell's set-up frames, window
  length bound, ATE prefix, traced frames, the check's sample and limits;
- ``slambench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None.

The program is built on an in-memory ``SLAMDataset`` of the generated
scans, as ``pin_slam.py`` builds it on a sequence read from disk; the
driver decides how its frames reach ``SlamSystem.process_frame``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
LAYER_PREFIX = "slambench."
# the forbidden top-level module names (JAX and the JAX package)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pin_slam_tpu")


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------


@dataclasses.dataclass
class CellSpec:
    name: str
    config_name: str
    config_file: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    cell: dict            # the cell's file
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> CellSpec:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"slambench: no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = os.path.join(root, cfg_entry["file"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return CellSpec(
        name=name, config_name=w["config"], config_file=cfg_file,
        config=_load_json(cfg_file),
        traffic=_load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        cell=_load_json(os.path.join(BENCH_DIR, "cells", name + ".json")),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def metric_reader(name: str) -> Callable:
    """``read`` of ``slambench/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("slambench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traffic_module(kind: str, name: str):
    """The generator (``kind`` "generators") or frame driver ("drivers")
    module ``slambench/<kind>/<name>.py`` a traffic mix names."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise SystemExit(f"slambench: {kind} name {name!r} is not a module name")
    return importlib.import_module(f"slambench.{kind}.{name}")


def forbidden_loaded(modules) -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


# ----------------------------------------------------------------------
# the record one run leaves for the metric readers
# ----------------------------------------------------------------------


@dataclasses.dataclass
class RunRecord:
    setup_s: float = 0.0
    frame_s: List[float] = dataclasses.field(default_factory=list)
    dataset_s: List[float] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    ate_rmse_m: Optional[float] = None        # over the window's first ate_frames frames
    stage_s: Optional[np.ndarray] = None      # (frames, 5) of the window, synchronised
    trace: dict = dataclasses.field(default_factory=dict)
    train_flops: float = 0.0                  # the window's training work
    tracker_flops: float = 0.0                # the window's tracker queries
    traced_train_work: tuple = (0.0, 0.0)     # (flops, bytes) of the traced frames
    infos: List[dict] = dataclasses.field(default_factory=list)
    error: Optional[str] = None               # the program raised: the run is not correct


# ----------------------------------------------------------------------
# wrappers: spans and counts around the calls into each layer
# ----------------------------------------------------------------------


class Probes:
    """``record_function`` spans around the calls into each layer, and the
    counts of the work the roofline and utilisation metrics read.  Installed
    on the instance (or module attribute) the pipeline calls through, for
    the traced run only; ``remove`` restores every attribute."""

    def __init__(self, system, cfg):
        from torch.profiler import record_function

        from pin_slam_torch.slam import tracker as trk
        from pin_slam_torch.slam import tracker_grad as tg
        from slambench import roofline

        self.rf = record_function
        self.undo = []
        self.counting = False
        self.traced = False
        self.train_flops = 0.0
        self.tracker_flops = 0.0
        self.traced_flops = 0.0
        self.traced_bytes = 0.0
        mc = system.mc
        F, H, vd, k = mc.feature_dim, cfg.geo_mlp_hidden_dim, mc.vec_dim, cfg.query_nn_k
        n_grad = cfg.bs // cfg.gradient_decimation if cfg.ekional_loss_on else 0
        self.iter_work = roofline.train_iteration_work(cfg.bs, k, F, H, vd, n_grad,
                                                       bool(cfg.weighted_first))
        self.query_flops = roofline.query_flops(F, H, vd) * k

        def train(fn):
            def wrapped(*a, **kw):
                n_it = a[8] if len(a) > 8 else kw["num_iters"]
                if self.counting:
                    self.train_flops += n_it * self.iter_work[0]
                if self.traced:
                    self.traced_flops += n_it * self.iter_work[0]
                    self.traced_bytes += n_it * self.iter_work[1]
                with record_function(LAYER_PREFIX + "training"):
                    return fn(*a, **kw)
            return wrapped

        def query(fn):
            def wrapped(*a, **kw):
                if self.counting:
                    self.tracker_flops += a[5].shape[0] * self.query_flops
                return fn(*a, **kw)
            return wrapped

        self._set(system, "_train", train(system._train))
        self._set(system, "_frame_update", self._span(system._frame_update, "map_update"))
        self._set(system, "_loop_closure_stage",
                  self._span(system._loop_closure_stage, "pgo.loop_closure"))
        self._set(system, "_bundle_adjustment", self._span(system._bundle_adjustment, "pgo.ba"))
        self._set(system, "_write_back", self._span(system._write_back, "write_back"))
        if system.loop_mgr is not None:
            self._set(system.loop_mgr, "add_node_device",
                      self._span(system.loop_mgr.add_node_device, "pgo.descriptor"))
        self._set(trk, "track_frame", self._span(trk.track_frame, "odometry"))
        self._set(tg, "sdf_value_and_grad_cached", query(tg.sdf_value_and_grad_cached))

    LABELS = tuple(LAYER_PREFIX + n for n in (
        "dataset", "odometry", "map_update", "training", "write_back", "pgo.loop_closure",
        "pgo.ba", "pgo.descriptor"))

    def _span(self, fn, label):
        rf = self.rf

        def wrapped(*a, **kw):
            with rf(LAYER_PREFIX + label):
                return fn(*a, **kw)
        return wrapped

    def _set(self, owner, name, value):
        self.undo.append(patch_attr(owner, name, value))

    def remove(self):
        for undo in reversed(self.undo):
            undo()
        self.undo = []


def patch_attr(owner, name, value) -> Callable[[], None]:
    """Set ``owner.name`` (an instance, so that a method of its class is
    shadowed, or a module); returns the function that undoes it."""
    missing = object()
    old = vars(owner).get(name, missing)
    setattr(owner, name, value)

    def undo():
        if old is missing:
            delattr(owner, name)          # the class's attribute shows again
        else:
            setattr(owner, name, old)
    return undo


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------


def build_config(spec: CellSpec, seed: int, overrides: Optional[dict] = None):
    from pin_slam_torch.config import Config

    cfg = Config().load(spec.config_file)
    cfg.seed = int(seed)
    cfg.o3d_vis_on = False
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)
    cfg._derive()
    return cfg


def config_values(cfg) -> dict:
    """The configuration's values the reference reads (inputs, not state)."""
    return {"main_loss_type": cfg.main_loss_type,
            "logistic_gaussian_ratio": cfg.logistic_gaussian_ratio,
            "sigma_sigmoid_m": cfg.sigma_sigmoid_m, "max_range_m": cfg.max_range,
            "min_range_m": cfg.min_range, "min_z_m": cfg.min_z, "max_z_m": cfg.max_z,
            "adaptive_range_on": cfg.adaptive_range_on, "query_nn_k": cfg.query_nn_k,
            "max_valid_dist2": cfg.max_valid_dist2}


def pose_books(system) -> list:
    ds = system.dataset
    return ds.pgo_poses if system.config.pgo_on else ds.odom_poses


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[dict] = None, sensor: Optional[dict] = None,
             plant: Optional[Callable] = None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``trace`` the ``breakdown``,
    and ``readings`` and ``checks``).  ``overrides`` (configuration keys)
    and ``sensor`` (keys of the sensor block) shrink a cell for the tests;
    a benchmark run passes neither, so the configuration's file alone sets
    the profile.  ``plant(system)`` breaks the timed path underneath (the
    control, and the faults) and returns its undo."""
    import torch

    from pin_slam_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_torch.slam.pipeline import SlamSystem

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from pin_slam_torch.ops import _cuda

        _cuda.build()
    cell = spec.cell
    gen_mod = traffic_module("generators", spec.traffic["generator"])
    driver = traffic_module("drivers", spec.traffic["driver"])
    cfg = build_config(spec, seed, overrides)
    gen = gen_mod.make({**spec.config["sensor"], **(sensor or {})}, spec.traffic, seed, dev)
    n_total = driver.frames_needed(cell, seconds, trace)
    cap = gen.max_frames()
    if cap is not None:
        n_total = min(n_total, cap)
    t0 = time.perf_counter()
    seq = gen.sequence(n_total)
    t1 = time.perf_counter()
    # the program's objects live in ``held`` alone, so that they can be
    # freed before the reference runs
    held = {}
    held["dataset"] = SLAMDataset(cfg, scans=seq.scans, gt_poses=seq.gt_poses, device=dev)
    held["system"] = SlamSystem(cfg, dataset=held["dataset"], device=dev, sync_stages=trace)
    log(f"set-up: {n_total} frames generated in {t1 - t0:.2f} s, system built in "
        f"{time.perf_counter() - t1:.2f} s")
    undo = plant(held["system"]) if plant is not None else None
    try:
        rec, out = driver.run(held, cell, cfg, seq, n_total, seconds, trace, dev, t_start,
                              spec.chips)
    finally:
        if undo is not None:
            undo()
    held.clear()
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window has closed, the peak is read and the
    # program's state is freed
    t_c = time.perf_counter()
    readings = check_readings(gen, out.pop("books"), out.pop("snap"), cfg, cell, seed,
                              out.pop("closures"))
    readings["ate_prefix_rmse_m"] = rec.ate_rmse_m     # reported, not compared
    ms = np.sort(np.asarray(rec.frame_s or [0.0]) * 1e3)
    q = np.percentile(ms, [50, 90, 95, 99, 100])
    top = ms[-max(1, len(ms) // 20):].mean()
    log(f"window: {len(rec.frame_s)} frames in {rec.window_s:.2f} s, frame ms p50 / p90 / "
        f"p95 / p99 / max {' / '.join(f'{v:.1f}' for v in q)}, slowest 5 % mean {top:.1f}; "
        f"check in {time.perf_counter() - t_c:.2f} s")
    limits = cell.get("limits", {})
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = (rec.error is None and bool(limits)
               and all(_within(readings[k], limits[k]) for k in limits))

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    res = {"correct": correct, "attempted": int(rec.attempted), "failed": int(rec.failed),
           "metrics": metrics, "device": out["device"]}
    if trace and rec.trace:
        res["breakdown"] = {"device_ops": rec.trace["top_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    res["readings"] = readings
    res["checks"] = checks
    return res


def report(e: Exception) -> str:
    """Logs what the program raised; returns its short form."""
    import traceback

    log("the program raised: " + "".join(traceback.format_exception(e)).rstrip())
    return repr(e)


def log(msg: str) -> None:
    import sys

    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


def _within(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def snapshot(system, cfg):
    """The program's map as it stands, copied out for the reference."""
    import torch

    from slambench import reference as ref

    st = system.state
    n = int(st.count)
    attr = st.attr_rows[:n].detach().clone()
    return ref.MapSnapshot(
        positions=attr[:, 0:3], quats=attr[:, 3:7],
        features=st.geo_features[:n].detach().clone(),
        layers=[(W.detach().clone(), None if b is None else b.detach().clone())
                for W, b in system.decoder.layers()],
        nn_k=int(cfg.query_nn_k), max_valid_dist2=float(cfg.max_valid_dist2),
        idw_eps=1e-15, sdf_scale=ref.sdf_scale(config_values(cfg)),
        rotate_offsets=bool(system.after_pgo)) if n else ref.MapSnapshot(
        positions=torch.zeros((0, 3)), quats=torch.zeros((0, 4)),
        features=torch.zeros((0, cfg.feature_dim)), layers=[], nn_k=int(cfg.query_nn_k),
        max_valid_dist2=float(cfg.max_valid_dist2), idw_eps=1e-15, sdf_scale=1.0,
        rotate_offsets=False)


def check_readings(gen, books, snap, cfg, cell, seed, closures) -> Dict[str, float]:
    """Every number the check can compare, from the reference."""
    from slambench import reference as ref

    out = dict(ref.pose_numbers(books, gen.frame_poses(len(books))))
    if snap.positions.shape[0]:
        q, truth = ref.sdf_queries(gen, books, config_values(cfg), cell["sample"], seed)
        out.update(ref.sdf_numbers(snap, q, truth))
    else:
        out.update({"sdf_err_p50_m": ref.NO_NEIGHBOUR_ERR_M,
                    "sdf_err_p90_m": ref.NO_NEIGHBOUR_ERR_M, "sdf_uncovered_share": 1.0,
                    "sdf_sign_err_share": 1.0})
    need = int(cell.get("closures_expected", 0))
    out["closures_missing"] = float(max(0, need - closures))
    return out
