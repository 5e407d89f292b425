"""Single-device training loop of the port (counterpart of
``repro/train/trainer.py``), eager: each step is ``forward_train``,
``loss.backward()``, the reference's schedule
(``linear_warmup_cosine(warmup=10, total=steps)``) and an in-place
``adamw.update``.

* Parameters are trainable leaves (``init_params(..., trainable=True)``,
  or the caller's via ``params=``); the state is ``{"params", "opt",
  "step"}``, ``step`` a 0-d int32 tensor on the device, so the schedule
  reads nothing back.
* Host reads: one per logged step (every metric of the step in one
  transfer); every other step waits for its loss on the device
  (a stream synchronize) and reads nothing.  The step time runs
  from the step's start to that read or wait.
* Checkpoint/restart: ``AsyncCheckpointer`` every ``ckpt_every`` steps
  and at the end; ``maybe_restore`` resumes from the latest one.  The
  data pipeline is a pure function of the step, so a resumed run
  replays the exact stream.
* Straggler watchdog: a step slower than ``watchdog_factor`` x the
  running median of the last 20 is logged in ``straggler_events``.

Runs on the card unless ``device="cpu"``; there the attention and MoE
products and the Mamba2 and rwkv6 scans run and differentiate through
their plain versions.  On the card every arch trains through the
kernels: the scans' gradients come from their backward kernels.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import forward_train, model_defs
from repro_torch.models.module import init_params
from repro_torch.optim import adamw, schedule


def train_step(state: Dict, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, ocfg: adamw.AdamWConfig, total: int, *,
               remat: bool = False, update=None) -> Dict[str, torch.Tensor]:
    """One step on ``state`` (``{"params", "opt", "step"}``): forward,
    backward, the schedule, then ``adamw.update`` in place on the params,
    or ``update(opt, lr)`` (returning the optimizer's metrics) where the
    caller steps other tensors (the dry-run's ZeRO-1 shards).  Returns
    the metrics as 0-d device tensors (``loss``, the MoE aux values,
    ``grad_norm``, ``lr``)."""
    params = state["params"]
    for p in params.parameters():
        p.grad = None
    loss, metrics = forward_train(params, cfg, batch, remat=remat)
    loss.backward()
    lr = schedule.linear_warmup_cosine(state["step"], peak_lr=ocfg.lr,
                                       warmup=10, total=total)
    if update is None:
        _, _, om = adamw.update(None, state["opt"], params, ocfg, lr)
    else:
        om = update(state["opt"], lr)
    for p in params.parameters():
        p.grad = None
    state["step"].add_(1)
    return {**{k: v.detach() for k, v in metrics.items()}, **om, "lr": lr}


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 64
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    watchdog_factor: float = 3.0
    peak_lr: float = 3e-4
    seed: int = 0
    remat: bool = False
    param_dtype: Any = None  # default fp32


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 device: DeviceLike = None, params=None):
        """``params``: the trainable ``ParamTree`` to train (default:
        ``init_params`` of the config from ``tc.seed`` on ``device``)."""
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.ocfg = adamw.AdamWConfig(lr=tc.peak_lr)
        if params is None:
            params = init_params(model_defs(cfg), tc.seed,
                                 tc.param_dtype or torch.float32,
                                 device=self.device, trainable=True)
        self.state = {"params": params,
                      "opt": adamw.init(params, self.ocfg),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        self.data = SyntheticLM(cfg, tc.batch, tc.seq_len, seed=tc.seed)
        self.step_times: List[float] = []
        self.straggler_events: List[Dict] = []
        self.metrics_history: List[Dict] = []
        self._ckpt = None
        if tc.ckpt_dir:
            from repro_torch.train.checkpoint import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(tc.ckpt_dir)

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a device batch (``train_step``)."""
        return train_step(self.state, batch, self.cfg, self.ocfg,
                          self.tc.steps, remat=self.tc.remat)

    def maybe_restore(self) -> int:
        if not self.tc.ckpt_dir:
            return 0
        from repro_torch.train import checkpoint as ck
        if ck.latest_step(self.tc.ckpt_dir) is None:
            return 0
        self.state, step = ck.restore(self.tc.ckpt_dir, self.state)
        return step

    def run(self, steps: Optional[int] = None) -> Dict:
        steps = steps or self.tc.steps
        start = int(self.state["step"])
        for step in range(start, steps):
            batch = to_device(self.data.batch_at(step), self.device)
            t0 = time.perf_counter()
            metrics = self.train_step(batch)
            logged = step % self.tc.log_every == 0 or step == steps - 1
            if logged:
                keys = sorted(metrics)
                vals = torch.stack([metrics[k].float().reshape(())
                                    for k in keys]).tolist()
            elif self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            if logged:
                row = dict(zip(keys, vals))
                row["step"] = step
                row["step_time_s"] = dt
                self.metrics_history.append(row)
            if (self._ckpt and self.tc.ckpt_every
                    and (step + 1) % self.tc.ckpt_every == 0):
                self._ckpt.save(self.state, step + 1)
        if self._ckpt:
            self._ckpt.save(self.state, steps)
            self._ckpt.wait()
        return {"final_loss": self.metrics_history[-1]["loss"],
                "history": self.metrics_history,
                "stragglers": self.straggler_events}

    def _watchdog(self, step: int, dt: float) -> None:
        if len(self.step_times) >= 5:
            med = statistics.median(self.step_times[-20:])
            if dt > self.tc.watchdog_factor * med:
                self.straggler_events.append(
                    {"step": step, "step_time_s": dt, "median_s": med})
        self.step_times.append(dt)


__all__ = ["TrainerConfig", "Trainer", "train_step"]
