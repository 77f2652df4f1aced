"""Train state and the trainers' common machinery.

Counterpart of ``diffute_tpu/train/state.py``.  The JAX state is an
immutable pytree replaced every step; this one is updated in place.
:class:`Trainer` holds what ``UNetTrainer``, ``VAETrainer`` and
``OCRTrainer`` share: fp32 master weights of the trained module (with a bf16
compute copy under ``mixed_precision="bf16"``), gradient accumulation, the
optimizer step, the EMA, the draw generator, and the ``state_dict`` /
``load_state_dict`` pair that checkpoints save and restore.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch

from diffute_tpu_torch.models.ema import EmaState
from diffute_tpu_torch.train.optim import AdamW, build_optimizer
from diffute_tpu_torch.utils.params import load_module


@dataclasses.dataclass
class TrainState:
    names: List[str]              # state_dict keys, in ``params`` order
    params: List[torch.Tensor]    # fp32 master weights
    opt: AdamW                    # first and second moments, count
    step: int = 0
    ema: Optional[EmaState] = None

    def params_dict(self) -> Dict[str, torch.Tensor]:
        """The master weights under their state_dict keys (no copy)."""
        return dict(zip(self.names, self.params))

    def state_dict(self) -> dict:
        """Masters, moments, EMA and counts (the tensors themselves, no
        copy): ``{"params": {key: t}, "opt": {"mu": {key: t}, "nu": {key:
        t}, "count"}, "ema": {"params": {key: t}, "step"} | None, "step"}``."""
        def named(ts):
            return dict(zip(self.names, ts))

        opt = self.opt.state_dict()
        ema = None
        if self.ema is not None:
            e = self.ema.state_dict()
            ema = {"params": named(e["params"]), "step": e["step"]}
        return {"params": named(self.params),
                "opt": {"mu": named(opt["mu"]), "nu": named(opt["nu"]),
                        "count": opt["count"]},
                "ema": ema, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy ``state`` (the layout of :meth:`state_dict`, tensors on any
        device) into this state's tensors; keys must match exactly."""
        def ordered(d, what):
            if set(d) != set(self.names):
                missing = sorted(set(self.names) - set(d))[:3]
                extra = sorted(set(d) - set(self.names))[:3]
                raise KeyError(f"{what}: missing {missing}, unexpected {extra}")
            return [d[n] for n in self.names]

        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint and the trainer disagree on "
                             "use_ema")
        for dst, src in zip(self.params, ordered(state["params"], "params")):
            dst.copy_(src)
        opt = state["opt"]
        self.opt.load_state_dict({"mu": ordered(opt["mu"], "mu"),
                                  "nu": ordered(opt["nu"], "nu"),
                                  "count": opt["count"]})
        if self.ema is not None:
            self.ema.load_state_dict({
                "params": ordered(state["ema"]["params"], "ema"),
                "step": state["ema"]["step"]})
        self.step = int(state["step"])


class Trainer:
    """Base of the trainers: one trained module on ``self.device`` in
    ``self.dtype`` with fp32 masters in ``self.state``.  A subclass sets
    ``config``, ``device``, ``dtype`` and ``bf16``, calls
    :meth:`_init_trained` and implements ``loss_fn(micro, draws)`` and
    ``draw(batch)``."""

    def _init_trained(self, cls, module_config,
                      params: Dict[str, torch.Tensor],
                      total_steps: Optional[int]) -> torch.nn.Module:
        """``cls(module_config)`` holding copies of ``params``, trainable,
        with the train state over fp32 masters and the draw generator."""
        tc = self.config.train
        names = list(params)
        # fp32 masters: copies, so the caller's tensors stay as they were
        masters = [params[n].detach().to(self.device, torch.float32,
                                         copy=True) for n in names]
        module = load_module(cls, module_config, dict(zip(names, masters)),
                             self.device, self.dtype)
        module.requires_grad_(True)
        self._compute_params = [module.get_parameter(n) for n in names]
        if not self.bf16:
            masters = self._compute_params  # the module's own fp32 weights
        total = total_steps or tc.max_train_steps or 10_000
        tbs = tc.train_batch_size * tc.gradient_accumulation_steps
        self.state = TrainState(
            names=names, params=masters,
            opt=build_optimizer(masters, tc.optimizer, total, tbs),
            ema=EmaState(masters) if tc.use_ema else None)
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        return module

    def accumulate_grads(self, batch, draws=None) -> torch.Tensor:
        """Mean loss of the batch's micro-batches, with the mean of their
        gradients left in the masters' ``.grad`` (fp32).

        With ``gradient_accumulation_steps > 1`` every array of ``batch``
        has leading dims (accum, micro) and ``draws`` is one draw per
        micro-batch (a list); None draws them from the trainer's
        generator."""
        accum = self.config.train.gradient_accumulation_steps
        micros = ([{k: v[i] for k, v in batch.items()} for i in range(accum)]
                  if accum > 1 else [batch])
        if draws is None:
            draws = [self.draw(len(next(iter(m.values())))) for m in micros]
        elif not isinstance(draws, (list, tuple)):
            draws = [draws]
        if len(draws) != len(micros):
            raise ValueError(f"{len(draws)} draws for {len(micros)} micro-batches")
        masters = self.state.params
        for p in masters:
            p.grad = None
        loss_sum = torch.zeros((), device=self.device)
        for micro, d in zip(micros, draws):
            loss = self.loss_fn(micro, d)
            loss.backward()
            loss_sum += loss.detach()
            if self.bf16:  # bf16 grads of the compute copy -> fp32 buffers
                for m, c in zip(masters, self._compute_params):
                    g = c.grad.float()
                    m.grad = g if m.grad is None else m.grad.add_(g)
                    c.grad = None
        if accum > 1:
            torch._foreach_div_([p.grad for p in masters], accum)
        return loss_sum / accum

    def apply_grads(self) -> torch.Tensor:
        """Clip, AdamW and EMA on the accumulated gradients; returns the
        pre-clip global gradient norm."""
        state = self.state
        grad_norm = state.opt.step()
        for p in state.params:
            p.grad = None
        self._refresh_compute_copy()
        if state.ema is not None:
            state.ema.update(state.params, self.config.train.ema_decay)
        state.step += 1
        return grad_norm

    def _refresh_compute_copy(self) -> None:
        if self.bf16:
            with torch.no_grad():
                torch._foreach_copy_(self._compute_params, self.state.params)

    def step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer step.  ``draws``: None (the trainer's generator), a
        ``torch.Generator`` on the trainer's device (it becomes the
        trainer's), or the draws themselves.  Returns 0-d tensors
        ``{"loss", "grad_norm"}``; reading them is the step's only host
        synchronisation."""
        if isinstance(draws, torch.Generator):
            self.generator, draws = draws, None
        loss = self.accumulate_grads(batch, draws)
        return {"loss": loss, "grad_norm": self.apply_grads()}

    # ------------------------------------------------------------------
    # checkpoint hooks

    def state_dict(self) -> dict:
        """The whole train state (no copies): :meth:`TrainState.state_dict`
        and the draw generator's state."""
        return {**self.state.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore :meth:`state_dict`'s layout: masters, moments, counts,
        EMA, step and generator; the bf16 compute copy follows the
        masters."""
        self.state.load_state_dict(state)
        self.generator.set_state(state["generator"].cpu())
        self._refresh_compute_copy()

