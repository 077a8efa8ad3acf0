"""Optional wandb logging, the port's copy of
``pin_slam_tpu/utils/wandb_log.py``: per-frame stage times and the run's
metrics.  A no-op unless ``config.wandb_vis_on`` is set AND the wandb
package is importable, so the call sites stay unconditional and cost nothing
when it is off."""

from __future__ import annotations

from typing import Optional

_run = None
_enabled = False


def setup_wandb(config, run_name: str = "") -> bool:
    """Initialize a wandb run from the Config.  Returns True when live
    logging is active."""
    global _run, _enabled
    _enabled = False
    if not getattr(config, "wandb_vis_on", False):
        return False
    try:
        import wandb
    except ImportError:
        if not config.silence:
            print("[wandb_log] wandb_vis_on set but wandb is not installed; "
                  "logging disabled")
        return False
    _run = wandb.init(project="pin-slam-torch", name=run_name or config.name,
                      config={k: v for k, v in vars(config).items()
                              if isinstance(v, (int, float, str, bool))})
    _enabled = True
    return True


def log(metrics: dict, step: Optional[int] = None) -> None:
    """Log a metrics dict (no-op unless setup_wandb enabled a run)."""
    if _enabled and _run is not None:
        _run.log(metrics, step=step)


def finish() -> None:
    global _run, _enabled
    if _enabled and _run is not None:
        _run.finish()
    _run, _enabled = None, False
