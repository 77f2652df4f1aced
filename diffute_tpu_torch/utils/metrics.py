"""Metric logging: tensorboard / wandb / comet trackers, or stdout.

Counterpart of ``diffute_tpu/utils/metrics.py``.  ``--report_to`` accepts
``tensorboard`` (default), ``wandb``, ``comet_ml``, ``all`` or ``none``.
Each tracker is used when its package imports (tensorboard through
``torch.utils.tensorboard``, else ``tensorboardX``); a requested tracker
that does not import is reported once and the scalars go to stdout in the
``[step N] key=value`` format, as in the JAX package.  Scalars may be 0-d
tensors: they are read once per log call.
"""

from __future__ import annotations

from typing import Dict, Optional

PROJECT_NAME = "text2image-fine-tune"


class MetricWriter:
    """Fan-out scalar writer.

    ``report_to``: "tensorboard" | "wandb" | "comet_ml" | "all" | "none".
    When no requested backend is importable, scalars go to stdout.
    """

    def __init__(self, logdir: Optional[str] = None,
                 report_to: str = "tensorboard", flush_every: int = 20,
                 project: str = PROJECT_NAME, config: Optional[dict] = None):
        self._tb = None
        self._wandb = None
        self._comet = None
        self._n = 0
        self._flush_every = flush_every
        want = (("tensorboard", "wandb", "comet_ml") if report_to == "all"
                else (report_to,))
        if "tensorboard" in want and logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except ImportError:
                try:
                    import tensorboardX

                    self._tb = tensorboardX.SummaryWriter(logdir)
                except ImportError:
                    self._warn("tensorboard")
        if "wandb" in want:
            try:
                import wandb

                self._wandb = wandb.init(project=project, dir=logdir,
                                         config=config or {})
            except ImportError:
                self._warn("wandb")
        if "comet_ml" in want:
            try:
                import comet_ml

                self._comet = comet_ml.Experiment(project_name=project)
                if config:
                    self._comet.log_parameters(config)
            except ImportError:
                self._warn("comet_ml")

    @staticmethod
    def _warn(name: str) -> None:
        print(f"[metrics] tracker '{name}' is not installed; "
              f"falling back to stdout", flush=True)

    @property
    def _has_backend(self) -> bool:
        return any(x is not None for x in (self._tb, self._wandb, self._comet))

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        vals = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(k, v, step)
            self._n += 1
            if self._n % self._flush_every == 0:
                self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(vals, step=step)
        if self._comet is not None:
            self._comet.log_metrics(vals, step=step)
        if not self._has_backend:
            line = " ".join(f"{k}={v:.5f}" for k, v in vals.items())
            print(f"[step {step}] {line}", flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()
