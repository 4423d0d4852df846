"""Train step: the torch twin of ``repro.train.step.make_train_step``.

The plan's ``ga_steps`` splits the batch into equal microbatches along its
first axis.  Each microbatch runs its own backward, with gradients in the
parameters' dtype (as JAX takes them), and adds them to an f32 accumulator
before the next one; the sum is divided by ``ga_steps`` and the reported
loss is the mean of the microbatch losses.  ``gc`` acts through the model's
``ModelOpts(remat="full")``, which the launcher sets from the plan.  One
device only (see ``repro_torch.parallel.plan``).
"""

from __future__ import annotations

import torch

from repro_torch.models.api import Model
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.train.optimizer import OptConfig, opt_update


def make_train_step(model: Model, plan: ExecutionPlan, optcfg: OptConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    params (the model's ``nn.Module``) and the optimizer state are updated
    in place, and every ``.grad`` is cleared again before it returns."""

    def train_step(params, opt_state, batch: dict):
        named = dict(params.named_parameters())
        if plan.ga_steps > 1:
            ga = plan.ga_steps
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            losses = []
            for i in range(ga):
                mb = {k: x.reshape((ga, x.shape[0] // ga) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss, _ = model.loss(params, mb)
                loss.backward()
                for n, p in named.items():
                    grads[n] += p.grad.float()
                    p.grad = None
                losses.append(loss.detach())
            for g in grads.values():
                g /= ga
            loss = torch.stack(losses).mean()
            metrics = {}
        else:
            loss, metrics = model.loss(params, batch)
            loss.backward()
            grads = {n: p.grad for n, p in named.items()}
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = opt_update(grads, opt_state, params, optcfg)
        for p in named.values():
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
