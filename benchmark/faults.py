"""Faults planted under the timed path, for the tests and for reading on the
card what each fault makes the comparison read: a cell's driver module
takes one as ``faults`` and wraps the program's step (training) or model
(inference)."""
from __future__ import annotations

import torch


class Unchanged:
    """A step that returns its state unchanged: the parameters are put back
    after each step."""

    def wrap_step(self, step, model, optimizer):
        def run(batch, seed):
            saved = [p.detach().clone() for p in model.parameters()]
            out = step(batch, seed)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return out
        return run


class HalfBatch:
    """Half of each batch left out: the step's means are over the rest."""

    def wrap_step(self, step, model, optimizer):
        def run(batch, seed):
            return step({k: v[: v.shape[0] // 2] for k, v in batch.items()}, seed)
        return run


class NoExchange:
    """The data-parallel step without the gradients' exchange between ranks:
    each rank's DDP hands back its own gradient."""

    def wrap_step(self, step, model, optimizer):
        from torch.nn.parallel import DistributedDataParallel

        ddp = next(c.cell_contents for c in step.__closure__ if isinstance(c.cell_contents, DistributedDataParallel))

        def local(state, bucket):
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer())
            return fut

        ddp.register_comm_hook(None, local)
        return step


class LoadsJax:
    """One rank of a data-parallel step loads a module named ``jax`` (an
    empty stand-in), as a port that imported JAX on the rank's side would."""

    def __init__(self, rank: int = 1):
        self.rank = rank

    def wrap_step(self, step, model, optimizer):
        import sys
        import types

        import torch.distributed as dist

        if dist.get_rank() == self.rank:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        return step


def altered(dets):
    """The detections with the first one's score raised by 1e-3."""
    bump = torch.zeros_like(dets.scores)
    bump.view(-1)[0] = 1e-3
    return dets._replace(scores=dets.scores + bump)


class AlteredAnswer:
    """A served detection altered where it is produced (``altered``)."""

    def wrap_model(self, model):
        class Served:
            module = model

            def __call__(self, batch):
                return altered(model(batch))
        return Served()
