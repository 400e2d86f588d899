"""One gloo rank of tests/test_torch_batchnorm.py's group check, in a module
that imports no JAX (each spawned rank imports it): the rank's half of a
batch through ``SyncBatchNorm``'s ``train=True`` form over the process
group, and a PreciseBN refresh of the narrow SyncBN detector on the rank's
own batch. Writes ``rank{r}.pt`` under ``out_dir``."""
import os

import torch

import chip_smoke
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine import hooks
from lvc_tpu_torch.modeling.layers import SyncBatchNorm
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.utils import comm


def narrow_syncbn_model(state_dict):
    """The narrow SyncBN Mask R-CNN (``chip_smoke.syncbn_opts(narrow=True)``,
    POOLER_IMPL exact) on the CPU with ``state_dict``'s weights."""
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(chip_smoke.syncbn_opts(narrow=True) + ["MODEL.ROI_HEADS.POOLER_IMPL", "exact"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model


def group_rank(out_dir, x, stats, batches, state_dict):
    r = comm.get_rank()
    bn = SyncBatchNorm(x.shape[1], process_group=torch.distributed.group.WORLD)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in stats.items()})
    half = len(x) // comm.get_world_size()
    y = bn(torch.from_numpy(x[half * r:half * (r + 1)]), train=True)
    model = narrow_syncbn_model(state_dict)
    n = hooks.update_bn_stats(model, [batches[r]])
    torch.save({"y": y.detach(), "stats": {k: getattr(bn, k) for k in ("running_mean", "running_var")}, "n": n,
                "buffers": {k: v for k, v in model.state_dict().items() if "running_" in k}},
               os.path.join(out_dir, f"rank{r}.pt"))
