"""A training cell of Swin Mask R-CNN: the program's AMP training step on
AdamW (``program.build_train_step``, as ``train_net`` builds it), fed from a
pool of device-resident batches with instance bitmasks
(``traffic.masks``), timed over a window of whole steps; the first steps are
the ones the plain reference (``reference/swin_mask.py``) follows. Its
readings are a training step's: the harness names the readers' mode by the
cell's driver (``benchmark/run.py``), so ``run`` reports "train".

Cell keys: ``train``'s (one rank, a device feed), with ``traffic.vertices``
the polygons' corner counts. Numbers: ``check.train_numbers``'s, with the
gradients as AdamW takes them (its first moment after one step over
1 - beta1) and the changes, both without the qkv biases' key thirds
(``reference.swin_mask.measured``), and ``mask_logit_gap``: the largest
over the first steps of ||program - reference|| / ||reference|| of the mask
logits (every class) of the foreground slots, which both sample alike.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import torch

from benchmark import check, counts, counts_swin, program
from benchmark.drivers.train import DeviceFeed, _norms, _to, print_steps
from benchmark.reference import boxes as bx
from benchmark.reference import swin_mask as ref
from benchmark.reference import swin_weights
from benchmark.traffic.masks import make_mask_pool

MODE = "train"


class MaskCapture(program.Capture):
    """``program.Capture`` that also keeps the mask head's logits."""

    def __init__(self, model):
        super().__init__(model)
        self._handles.append(model.roi_heads.mask_head.register_forward_hook(self._mask))

    def _mask(self, module, inputs, output):
        if self.active:
            self.calls[-1]["mask_logits"] = output.detach().float()


def replay_selection(cfg: Dict, call: Dict, image_sizes: torch.Tensor):
    """``check.replay_selection`` with the Swin detector's selection."""
    B = image_sizes.shape[0]
    if call["logits"][0].shape[0] != B:  # proposals for another number of images than the batch's
        return None, B * cfg["MODEL.RPN.POST_NMS_TOPK_TRAIN"]
    det = ref.SwinMaskDetector(cfg, {})
    anchors = bx.grid_anchors(cfg["MODEL.ANCHOR_GENERATOR.SIZES"], cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"],
                              det.strides, call["grids"], image_sizes.device)
    boxes, valid, sel = det.select(anchors, call["logits"], call["deltas"], image_sizes, True)
    bad = (valid != call["prop_valid"]) | (valid & (boxes != call["proposals"]).any(-1))
    return sel, int(bad.sum())


@torch.no_grad()
def mask_logit_gap(prog_logits: List[torch.Tensor], ref_logits: List[torch.Tensor], rows: List[torch.Tensor]):
    """The largest over the steps of the relative gap of the foreground
    slots' logits; a slot the program did not compute (fewer slots than the
    reference's) reads 0."""
    gap = 0.0
    for p, r, idx in zip(prog_logits, ref_logits, rows):
        if idx.numel() == 0:
            continue
        idx = idx.to(p.device)
        have = idx < p.shape[0]
        got = torch.zeros((idx.numel(),) + tuple(p.shape[1:]), dtype=p.dtype, device=p.device)
        got[have] = p[idx[have]]
        g = check.logit_gap([got.to(r.device)], [r])
        gap = g if not g <= gap else gap
    return gap


@contextlib.contextmanager
def tf32_off():
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def reference_numbers(cfgd: Dict, params0, batches, seeds, prog: Dict) -> Dict[str, float]:
    """The reference's float32 steps along the program's choices (TF32 off
    by the caller), and the comparison."""
    out = ref.steps(cfgd, params0, batches, seeds, "fp32", prog["selections"])
    numbers = check.train_numbers(cfgd, prog, out)
    numbers["mask_logit_gap"] = mask_logit_gap(prog["mask_logits"], out["mask_logits"], out["fg_rows"])
    return numbers


def played(cfgd: Dict, cell: Dict, seed: int, device, precision: str) -> Dict[str, float]:
    """The reference in the program's place at ``precision`` (a control),
    judged as the program is."""
    params0 = swin_weights.make(cfgd, bx.fold_in(seed, 1), device)
    pool = make_mask_pool(cell["traffic"], cfgd, bx.fold_in(seed, 2), device)
    n = cell["check_steps"]
    batches = [pool[i % len(pool)] for i in range(n)]
    seeds = [bx.fold_in(seed, 3, i) for i in range(n)]
    with tf32_off():
        play = ref.steps(cfgd, params0, batches, seeds, precision)
        full_logits = []
        for logits, rows, batch in zip(play["mask_logits"], play["fg_rows"], batches):
            whole = torch.zeros((batch["image"].shape[0] * cfgd["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"],)
                                + tuple(logits.shape[1:]), device=device)
            whole[rows] = logits
            full_logits.append(whole)
        return reference_numbers(cfgd, params0, batches, seeds,
                                 dict(play, proposal_mismatch=0, mask_logits=full_logits))


def run(cell: Dict, config: Dict, seed: int, seconds: float, trace: bool, device, overrides=None, faults=None,
        kernels=()):
    """One run: the dict of ``drivers.train.run``, its ``kernel_least_ms``
    also holding ``"swin.attention"`` (the attention branches' least ms
    over the traced steps, ``counts_swin.attention_least_ms``)."""
    from benchmark.trace import Profile

    if cell["traffic"].get("ranks", 1) != 1 or cell["traffic"]["feed"] != "device":
        raise ValueError("train_swin_mask runs one rank on a device feed")
    marks = [("imports", time.time())]
    cell["driver"] = MODE
    cfgd = dict(config["cfg"], **(overrides or {}))
    cfg = program.port_cfg(config, overrides)
    traffic = cell["traffic"]
    weights = swin_weights.make(cfgd, bx.fold_in(seed, 1), device)
    model = program.build_model(cfg, weights, device)
    marks.append(("model and weights", time.time()))
    p0 = {k: v.detach().clone() for k, v in weights.items()}
    del weights
    step, optimizer = program.build_train_step(cfg, model)
    beta1 = cfg.SOLVER.BETAS[0]
    if faults:
        step = faults.wrap_step(step, model, optimizer)
    feed = DeviceFeed(make_mask_pool(traffic, cfgd, bx.fold_in(seed, 2), device))
    pool_flops = {id(b): sum(counts_swin.model_flops(cfgd, *b["image"].shape[1:3], int(g))
                             for g in b["gt_valid"].sum(1).tolist()) for b in feed.pool}

    def step_seed(i: int) -> int:
        return bx.fold_in(seed, 3, i)

    names = {id(p): n for n, p in model.named_parameters()}
    marks.append(("step and traffic", time.time()))

    capture = MaskCapture(model)
    n_check = cell["check_steps"]
    batches, captures, losses, grad_norms, update_norms = [], [], [], {}, {}
    canvases, i = set(), 0
    while i < n_check or (len(canvases) < len(set(traffic["canvases"])) and i < 4 * n_check):
        batch, _, whole = feed.next()
        canvases.add(tuple(batch["image"].shape[1:3]))
        if i < n_check:
            capture.begin()
        metrics = step(batch, step_seed(i))
        capture.end()
        if i < n_check:
            losses.append({k: float(v) for k, v in metrics.items()})
            captures.append({k: _to(v, "cpu") for k, v in capture.calls[-1].items()})
            capture.calls.clear()
            batches.append(whole)
        if i == 0:
            grad_norms = _norms({names[id(p)]: ref.measured(names[id(p)], st["exp_avg"] / (1 - beta1))
                                 for p, st in optimizer.state.items()})
        if i == n_check - 1:
            params = dict(model.named_parameters())
            update_norms = _norms({k: ref.measured(k, params[k].detach() - p0[k]) for k in p0})
            del p0
        i += 1
    capture.remove()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    B = traffic["batch"]
    setup_done = time.time()
    marks.append(("first steps", setup_done))
    flops, steps, ends = 0.0, 0, []
    t0 = time.perf_counter()
    ends.append(t0)
    while time.perf_counter() - t0 < seconds:
        batch, _, whole = feed.next()
        step(batch, step_seed(i))
        flops += pool_flops[id(whole)]
        i += 1
        steps += 1
        ends.append(time.perf_counter())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    print_steps(ends)
    peak, _ = counts.peak_flops(cfgd, train=True)
    window = {"seconds": window_s, "steps": steps, "images": steps * B, "flops": flops, "peak_flops": peak,
              "loader_waits": None}

    summary, least_ms, traced = None, {}, 0
    if trace:
        attention_ms = 0.0
        with program.KernelCalls(kernels) as kc, Profile(program.RANGES_TRAIN) as prof:
            for _ in range(cell["trace_steps"]):
                batch, _, _ = feed.next()
                step(batch, step_seed(i))
                H, W = batch["image"].shape[1:3]
                attention_ms += counts_swin.attention_least_ms(cfgd, B, H, W)
                i += 1
                traced += 1
        summary = prof.summary
        least_ms = dict(kc.least_ms(), **{"swin.attention": attention_ms})
        del kc
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the program's readings, then its state is freed and the reference runs
    sels, mismatch = [], 0
    for call, batch in zip(captures, batches):
        call = {k: _to(v, device) for k, v in call.items() if k != "mask_logits"}
        sel, bad = replay_selection(cfgd, call, batch["image_size"])
        sels.append(None if sel is None else {"selection": sel, "proposals": call["proposals"]})
        mismatch += bad
    prog = {"losses": [{k: v for k, v in d.items() if k != "total_loss"} for d in losses],
            "grad_norms": grad_norms, "update_norms": update_norms, "selections": sels,
            "rpn_logits": [[t.to(device) for t in c["logits"]] for c in captures], "proposal_mismatch": mismatch,
            "mask_logits": [c["mask_logits"] for c in captures]}
    del model, optimizer, step, capture, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with tf32_off():
        params0 = swin_weights.make(cfgd, bx.fold_in(seed, 1), device)
        numbers = reference_numbers(cfgd, params0, batches, [step_seed(j) for j in range(n_check)], prog)
    return {"setup_done": setup_done, "setup_marks": marks, "window": window, "trace": summary, "traced_steps": traced,
            "kernel_least_ms": least_ms, "memory_peak_bytes": memory_peak, "numbers": numbers,
            "attempted": steps, "failed": 0, "e2e": {"train_img_per_s": window["images"] / window_s}}
